"""Device busy ms per round of the work launched inside `wpfed.exchange`
(own and neighbour forwards, the fused exchange kernel): the union of
those events' intervals. Moves round_s."""


def read(ctx):
    us = ctx.trace.device_us(["wpfed.exchange"])
    return us / 1e3 / ctx.rounds if us > 0 and ctx.rounds else None
