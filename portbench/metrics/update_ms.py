"""Device busy ms per round of the work launched inside `wpfed.update`
(the local Adam steps: `protocol.update_phase`, `batched_local_update`,
`optim/optimizers.py`): the union of those events' intervals, each event
given to the span of the call that launched it. Moves round_s."""


def read(ctx):
    us = ctx.trace.device_us(["wpfed.update"])
    return us / 1e3 / ctx.rounds if us > 0 and ctx.rounds else None
