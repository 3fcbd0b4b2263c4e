"""One minus the union of device-activity intervals over the profiled
stretch's wall time, in %. Moves round_s."""


def read(ctx):
    wall = ctx.trace.wall_us() if ctx.trace.stretch else 0.0
    if wall <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / wall)
