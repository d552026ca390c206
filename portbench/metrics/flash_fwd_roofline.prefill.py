"""The flash forward's share of its roofline in the traced batch's prefill,
timed by the program's spans: ``flash_fwd_roofline``'s least time (each
attention call of the traced prefill, one a layer, at the batch's shape,
causal, from the frozen work formula) over the device time of the
``flash_attention`` spans under ``serve.prefill``. Flash calls of decode
steps fall outside it. None without spans."""
from portbench import spans as spanlog
from portbench.yardstick import attention_cost, bound_s

LAYER = "flash kernels"
UNIT = "%"
MOVES = "ttft_p90_ms"


def read(ctx, got, trace):
    calls = spanlog.under(spanlog.log() or [], "flash_attention", "serve.prefill")
    if not calls:
        return None
    m = ctx.model
    D = m.get("head_dim") or m["d_model"] // m["n_heads"]
    least = sum(m["n_layers"] * bound_s(*attention_cost(
        b.rows, b.prompt_len, b.prompt_len, m["n_heads"], m["n_kv_heads"], D))
        for b in got["run"].batches if b.traced)
    return 100.0 * least / sum(spanlog.device_s(s) for s, _ in calls)
