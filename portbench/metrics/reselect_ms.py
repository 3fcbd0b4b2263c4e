"""Device busy ms per global round of the work launched inside
`wpfed.select` and `wpfed.announce` (selection, exact or through the
LSH-bucket candidates; the Eq. 5 projection, rankings, commitments): the
union of those events' intervals. Moves round_s."""


def read(ctx):
    us = ctx.trace.device_us(["wpfed.select", "wpfed.announce"])
    return us / 1e3 / ctx.global_rounds if us > 0 and ctx.global_rounds \
        else None
