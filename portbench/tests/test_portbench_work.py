"""The frozen yardstick against the program's own counts at the cells'
shapes (only the tests import the program for this)."""
import json
from pathlib import Path

import pytest

from portbench import harness, yardstick
from portbench.reference import decoder

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _shapes():
    """(B, S, H, KVH, D, moe) of each cell's attention and expert calls."""
    out = []
    for cell in BENCH["workloads"]:
        m = harness.config(cell["config"])["model"]
        mix = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
        D = m["d_model"] // m["n_heads"]
        lengths = mix.get("prompt_lengths") or [mix["seq_len"]]
        for S in lengths:
            out.append((cell["name"], mix["batch"], S, m["n_heads"], m["n_kv_heads"], D,
                        m.get("moe")))
    return out


@pytest.mark.parametrize("shape", _shapes(), ids=lambda s: f"{s[0]}-{s[2]}")
def test_attention_formulas_are_the_programs(shape):
    from repro_torch.kernels import flash_attention as fa
    _, B, S, H, KVH, D, _ = shape
    for lse in (False, True):
        assert yardstick.attention_cost(B, S, S, H, KVH, D, with_lse=lse) == \
            fa.attention_cost(B, S, S, H, KVH, D, with_lse=lse)
    assert yardstick.attention_bwd_cost(B, S, S, H, KVH, D) == \
        fa.attention_bwd_cost(B, S, S, H, KVH, D)
    assert yardstick.attention_cost(B, 1, S + 1, H, KVH, D, q_offset=S) == \
        fa.attention_cost(B, 1, S + 1, H, KVH, D, q_offset=S)


@pytest.mark.parametrize("shape", [s for s in _shapes() if s[6]], ids=lambda s: s[0])
def test_gmm_formulas_are_the_programs(shape):
    from repro_torch.kernels import moe_gmm
    _, B, S, _, _, _, moe = shape
    E, f = moe["num_experts"], moe["d_ff_expert"]
    C = B * S * moe["top_k"] // E
    for d_in, d_out in ((2048, f), (f, 2048)):
        assert yardstick.gmm_cost(E, C, d_in, d_out) == moe_gmm.gmm_cost(E, C, d_in, d_out)
        assert yardstick.gmm_bwd_cost(E, C, d_in, d_out) == \
            moe_gmm.gmm_bwd_cost(E, C, d_in, d_out)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_model_flops_count_the_programs_active_parameters(name):
    """2 x the parameters a token multiplies through: the program's active
    count less its embedding and norm scales (which multiply nothing)."""
    from repro_torch.models.model_zoo import build_model
    from portbench.harness import Context
    conf = harness.config(name)
    ctx = Context({}, conf, {}, 0, 0, None, None, 0)
    model = build_model(ctx.program_config())
    m = conf["model"]
    norms = (2 * m["n_layers"] + 1) * m["d_model"]
    got = sum(decoder.matmul_params(m).values())
    assert got == model.active_param_count() - m["vocab_size"] * m["d_model"] - norms


def test_peaks():
    assert yardstick.PEAK_BF16_FLOPS == 989e12 and yardstick.PEAK_HBM_BYTES == 3.35e12
    assert yardstick.bound_s(989e12, 0) == 1.0 and yardstick.bound_s(0, 3.35e12) == 1.0
