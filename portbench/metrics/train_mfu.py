"""The train steps' model FLOPs over their time, as a share of the bf16
peak: 3 x the configuration's family's ``forward_flops`` over the step's
rows a step (remat's recompute not counted). Time: the host's clock around
each untraced step of the window, each ending in a sync."""
from portbench.yardstick import PEAK_BF16_FLOPS

LAYER = "train step"
UNIT = "%"
MOVES = "train_tok_s"


def read(ctx, got, trace):
    steps = got["run"].steps[ctx.mix.get("trace", {}).get("steps", 1):]
    if not steps:
        return None
    flops = 3 * ctx.family.forward_flops(ctx.model, ctx.mix["batch"], ctx.mix["seq_len"], 0)
    return 100.0 * flops * len(steps) / (sum(s for s, _ in steps) * PEAK_BF16_FLOPS)
