"""The Eq. 5 projection's least time over the device busy time of the
work launched inside `wpfed.announce`, in %. The least time is the
larger of 2 * M * P * bits over the f32 peak (TF32 is off) and the
M * P f32 parameters read once over the memory bandwidth
(`flops.announce_least_s`, from the shapes, whatever kernel implements
it). Moves round_s."""


def read(ctx):
    us = ctx.trace.device_us(["wpfed.announce"])
    if us <= 0 or not ctx.global_rounds:
        return None
    return 100.0 * ctx.announce_least_s / (us / 1e6 / ctx.global_rounds)
