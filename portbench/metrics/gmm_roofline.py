"""The expert kernels' share of their roofline in the traced steps.

The work is that of the routed assignments, not of the capacity padding:
R = tokens x top_k rows through each of the three expert products (gate,
up: d -> f; down: f -> d) of every MoE layer, once a forward call (twice a
step under full remat: the forward and its recompute) and once a backward
call (dx and dw), from the frozen formulas with all E experts' weights read;
over the device time of the kernels named below."""
from portbench.yardstick import bound_s, gmm_bwd_cost, gmm_cost

LAYER = "expert kernels"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ("gmm_wgmma_kernel", "gmm_bf16_kernel")


def read(ctx, got, trace):
    m, mix = ctx.model, ctx.mix
    moe = m.get("moe")
    if not moe:
        return None
    E, d, f = moe["num_experts"], m["d_model"], moe["d_ff_expert"]
    per = mix["batch"] * mix["seq_len"] * moe["top_k"] / E
    forwards = 2 if mix["remat"] == "full" else 1
    products = [(d, f), (d, f), (f, d)]
    layer = sum(forwards * bound_s(*gmm_cost(E, per, a, b)) +
                bound_s(*gmm_bwd_cost(E, per, a, b)) for a, b in products)
    steps = mix.get("trace", {}).get("steps", 1)
    least = steps * (m["n_layers"] - moe.get("first_k_dense", 0)) * layer
    seconds, launches = trace.time_of(KERNELS)
    if not launches:
        raise RuntimeError(f"no device operation in the trace matches {KERNELS}")
    return 100.0 * least / seconds
