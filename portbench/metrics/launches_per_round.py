"""Device kernels, memcpys and memsets over the profiled stretch, per
round (the round engine's host dispatch: every vmapped call's launches).
Moves round_s."""


def read(ctx):
    if not ctx.trace.device or not ctx.rounds:
        return None
    return len(ctx.trace.in_stretch()) / ctx.rounds
