"""The flash forward kernel's share of its roofline in the traced batch.

The least time of each attention call of the traced prefill (one a layer,
at the batch's shape, causal), from the frozen work formula, summed, over
the device time of the kernels named below in the trace."""
from portbench.yardstick import attention_cost, bound_s

LAYER = "flash kernels"
UNIT = "%"
MOVES = "ttft_p90_ms"
KERNELS = ("flash_fwd_kernel",)


def read(ctx, got, trace):
    m = ctx.model
    D = m.get("head_dim") or m["d_model"] // m["n_heads"]
    least = sum(m["n_layers"] * bound_s(*attention_cost(
        b.rows, b.prompt_len, b.prompt_len, m["n_heads"], m["n_kv_heads"], D))
        for b in got["run"].batches if b.traced)
    seconds, launches = trace.time_of(KERNELS)
    if not launches:
        raise RuntimeError(f"no device operation in the trace matches {KERNELS}")
    return 100.0 * least / seconds
