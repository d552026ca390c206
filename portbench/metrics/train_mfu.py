"""The train steps' model FLOPs over their time, as a share of the bf16
peak: (6 x the parameters a token multiplies through x tokens + 3 x the
forward's causal attention products) a step, from the configuration's
widths; remat's recompute is not counted. Time: the host's clock around
each untraced step of the window, each ending in a sync."""
from portbench.yardstick import PEAK_BF16_FLOPS, train_flops

LAYER = "train step"
UNIT = "%"
MOVES = "train_tok_s"


def read(ctx, got, trace):
    steps = got["run"].steps[ctx.mix.get("trace", {}).get("steps", 1):]
    if not steps:
        return None
    flops = train_flops(ctx.model, ctx.mix["batch"], ctx.mix["seq_len"])
    return 100.0 * flops * len(steps) / (sum(s for s, _ in steps) * PEAK_BF16_FLOPS)
