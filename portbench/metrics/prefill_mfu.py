"""The prefills' model FLOPs over their time, as a share of the bf16 peak.

FLOPs: the configuration's family's ``forward_flops`` of each batch's
prefill (its rows, its prompt, no earlier positions). Time: each batch's
CUDA events from its start to the end of its prefill step, over the whole
window."""
from portbench.yardstick import PEAK_BF16_FLOPS

LAYER = "model step, prefill"
UNIT = "%"
MOVES = "ttft_p90_ms"


def read(ctx, got, trace):
    batches = got["run"].batches
    flops = sum(ctx.family.forward_flops(ctx.model, b.rows, b.prompt_len, 0)
                for b in batches)
    seconds = sum(b.ttft_ms() for b in batches) / 1e3
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
