"""The decode steps' model FLOPs over their time, as a share of the bf16
peak: the steps ``decode_step_ms`` counts (every untraced batch's; a traced
one's after its slice closed), each the configuration's family's
``forward_flops`` of one new position over the batch's rows after the
prompt_len + index earlier ones the step's cache holds; over the same CUDA
events' time (each batch's prefill end to its end). None without such
steps."""
from portbench.yardstick import PEAK_BF16_FLOPS

LAYER = "session decode loop"
UNIT = "%"
MOVES = "output_tok_s"


def read(ctx, got, trace):
    flops = ms = 0.0
    for b in got["run"].batches:
        t, n = b.untraced_decode()
        if not n:
            continue
        first = b.decode_steps - n          # the index of the first step counted
        flops += sum(ctx.family.forward_flops(ctx.model, b.rows, 1, b.prompt_len + i)
                     for i in range(first, b.decode_steps))
        ms += t
    if not ms:
        return None
    return 100.0 * flops / (ms / 1e3 * PEAK_BF16_FLOPS)
