"""The yardstick: peaks of the card and the work of each call, frozen.

These are copies, kept with the benchmark so that a change to the program
cannot move them. The kernels' work formulas are those of
``repro_torch/kernels/flash_attention.py::attention_cost`` and
``attention_bwd_cost`` and ``repro_torch/kernels/moe_gmm.py::gmm_cost`` and
``gmm_bwd_cost`` as they stood when the benchmark was written (a test holds
them equal at the cells' shapes). None of this depends on a model's
family: the model FLOPs of a step are the family's (``forward_flops`` in
the module ``reference/<family>.py``), from the configuration's widths,
never from the program's own parameter counts.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def attended_pairs(Sq, Sk, *, causal=True, window=0, q_offset=0,
                   kv_valid=None) -> int:
    """(q, k) pairs the masks leave for these inputs: the work the data needs."""
    kv_valid = Sk if kv_valid is None else min(int(kv_valid), Sk)
    qp = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    hi = np.minimum(kv_valid, qp + 1) if causal else np.full(Sq, kv_valid)
    lo = np.maximum(0, qp - window + 1) if window else 0
    return int(np.maximum(hi - lo, 0).sum())


def attention_cost(B, Sq, Sk, H, KVH, D, *, causal=True, window=0, q_offset=0,
                   kv_valid=None, with_lse=False) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one flash forward call: 4 B H D an attended
    pair; q, k, v read and the output written once in bf16, the rows'
    log-sum-exp in fp32 where it is written."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window,
                           q_offset=q_offset, kv_valid=kv_valid)
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KVH * D)
    return 4 * B * H * D * pairs, nbytes + (4 * B * H * Sq if with_lse else 0)


def attention_bwd_cost(B, Sq, Sk, H, KVH, D, *, causal=True, window=0,
                       kv_valid=None) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one flash backward call: five products, 10 B H
    D an attended pair; q, k, v, o, dO and the LSE read and dQ, dK, dV
    written once."""
    pairs = attended_pairs(Sq, Sk, causal=causal, window=window,
                           kv_valid=kv_valid)
    nbytes = 2 * (6 * B * Sq * H * D + 4 * B * Sk * KVH * D) + 4 * B * H * Sq
    return 10 * B * H * D * pairs, nbytes


def gmm_cost(E, C, d, f, esize: int = 2) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one grouped matmul over E C rows: 2 E C d f
    operations; x, w and the output read or written once."""
    return 2 * E * C * d * f, esize * (E * C * d + E * d * f + E * C * f)


def gmm_bwd_cost(E, C, d, f, esize: int = 2) -> tuple[int, int]:
    """(FLOPs, HBM bytes) of one grouped matmul's backward, dx and dw."""
    return 4 * E * C * d * f, esize * (2 * E * C * d + 2 * E * d * f + E * C * f)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
