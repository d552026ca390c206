"""The prefills' model FLOPs over their time, as a share of the bf16 peak.

FLOPs: 2 x the parameters a token multiplies through (the lm_head
included, from the configuration's widths) x the prompt tokens, plus the
causal attention products. Time: each batch's CUDA events from its start
to the end of its prefill step, over the whole window."""
from portbench.yardstick import PEAK_BF16_FLOPS, forward_flops

LAYER = "model step, prefill"
UNIT = "%"
MOVES = "ttft_p90_ms"


def read(ctx, got, trace):
    batches = got["run"].batches
    flops = sum(forward_flops(ctx.model, b.rows, b.prompt_len) for b in batches)
    seconds = sum(b.ttft_ms() for b in batches) / 1e3
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
