"""The decode steps' model FLOPs over their time, as a share of the bf16
peak: the steps ``decode_step_ms`` counts (every untraced batch's; a traced
one's after its slice closed), each 2 x the parameters a token multiplies
through (the lm_head included, from the configuration's widths) x the
batch's rows, plus its attention products, 4 x rows x H x D x kv a layer
over the kv = prompt_len + index + 1 positions the step sees; over the same
CUDA events' time (each batch's prefill end to its end). None without such
steps."""
from portbench.yardstick import PEAK_BF16_FLOPS, matmul_params

LAYER = "session decode loop"
UNIT = "%"
MOVES = "output_tok_s"


def read(ctx, got, trace):
    m = ctx.model
    per_token = sum(matmul_params(m).values())
    D = m.get("head_dim") or m["d_model"] // m["n_heads"]
    flops = ms = 0.0
    for b in got["run"].batches:
        t, n = b.untraced_decode()
        if not n:
            continue
        first = b.decode_steps - n          # the index of the first step counted
        kv = sum(b.prompt_len + i + 1 for i in range(first, b.decode_steps))
        flops += 2.0 * per_token * b.rows * n + \
            4.0 * b.rows * m["n_heads"] * D * kv * m["n_layers"]
        ms += t
    if not ms:
        return None
    return 100.0 * flops / (ms / 1e3 * PEAK_BF16_FLOPS)
