"""Decode attention's share of its roofline in the traced slice, timed by
the program's spans: the least time of each ``decode_attention_kernel`` span
under a ``serve.decode_step`` whose device interval ends inside the slice
(one layer's call: ``yardstick.attention_cost`` at the traced batch's rows,
one query row a head over the kv = prompt_len + index + 1 positions the
step sees, causal, so the visible K and V read once), summed, over the sum
of those spans' device time. None without such spans (a program without
the kernel)."""
from portbench import spans as spanlog
from portbench.yardstick import attention_cost, bound_s

LAYER = "decode attention"
UNIT = "%"
MOVES = "output_tok_s"
SPAN = "decode_attention_kernel"
KERNELS = ("decode_scores_kernel", "decode_pv_kernel")    # what a span holds


def read(ctx, got, trace):
    end = spanlog.slice_end_us(trace)
    calls = [(s, step) for s, step in spanlog.under(spanlog.log() or [], SPAN,
                                                     "serve.decode_step")
             if end is None or spanlog.device_us(s)[1] <= end]
    if not calls:
        return None
    batch = next(b for b in got["run"].batches if b.traced)
    m = ctx.model
    D = m.get("head_dim") or m["d_model"] // m["n_heads"]
    least = 0.0
    for _, step in calls:
        kv = batch.prompt_len + step.attrs["index"] + 1
        least += bound_s(*attention_cost(batch.rows, 1, kv, m["n_heads"],
                                         m["n_kv_heads"], D, causal=True,
                                         q_offset=kv - 1))
    return 100.0 * least / sum(spanlog.device_s(s) for s, _ in calls)
