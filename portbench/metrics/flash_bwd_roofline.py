"""The flash backward kernels' share of their roofline in the traced
steps: the least time of each backward call (one a layer a step, at the
step's shape, causal), from the frozen work formula, summed, over the
device time of the kernels named below."""
from portbench.yardstick import attention_bwd_cost, bound_s

LAYER = "flash kernels"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel", "flash_bwd_delta_kernel")


def read(ctx, got, trace):
    m, mix = ctx.model, ctx.mix
    D = m.get("head_dim") or m["d_model"] // m["n_heads"]
    steps = mix.get("trace", {}).get("steps", 1)
    least = steps * m["n_layers"] * bound_s(*attention_bwd_cost(
        mix["batch"], mix["seq_len"], mix["seq_len"], m["n_heads"], m["n_kv_heads"], D))
    seconds, launches = trace.time_of(KERNELS)
    if not launches:
        raise RuntimeError(f"no device operation in the trace matches {KERNELS}")
    return 100.0 * least / seconds
