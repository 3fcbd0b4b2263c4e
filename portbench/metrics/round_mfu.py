"""Model FLOPs a round (update, neighbour web and own forwards, counted
once on meta by `flops.count` and frozen in `cells/<cell>.json`) over
the round time of the unprofiled window times the f32 peak, in %.
Moves round_s."""


def read(ctx):
    if not ctx.flops_per_round or not ctx.round_s:
        return None
    return 100.0 * ctx.flops_per_round / (ctx.round_s * ctx.peaks["f32"])
