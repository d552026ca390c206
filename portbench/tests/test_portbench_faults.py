"""The harness run end to end on the CPU at a tiny size (its look for a
card skipped), with the timed path broken underneath: ``correct`` must
come out false for each fault a cell can have, and true without one. The
limits are the cells' own; the tiny models compute in fp32, so that a
sound run sits far under limits set for bf16 at full size."""
import time

import pytest

from portbench import harness
from portbench.faults import (alter_a_decoded_token, alter_first_token, half_the_batch,
                              unchanged_state)

DENSE = {"model": {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64,
                   "n_heads": 4, "n_kv_heads": 4, "d_ff": 128, "vocab_size": 256,
                   "rope_theta": 10000.0, "tie_embeddings": False,
                   "param_dtype": "float32", "activ_dtype": "float32"}}
MOE = {"model": {"name": "tinymoe", "family": "moe", "n_layers": 3, "d_model": 64,
                 "n_heads": 4, "n_kv_heads": 4, "d_ff": 0, "vocab_size": 256,
                 "tie_embeddings": False, "param_dtype": "float32",
                 "activ_dtype": "float32",
                 "moe": {"num_experts": 8, "top_k": 2, "num_shared": 2, "d_ff_expert": 32,
                         "capacity_factor": 64.0, "router_aux_coef": 0.01,
                         "first_k_dense": 1, "d_ff_dense": 128}}}
SERVE = {"kind": "serve", "batch": 2, "prompt_lengths": [8, 12], "new_tokens": 4,
         "warmup_new_tokens": 2, "check": {"requests": 4}, "trace": {}}


def train_mix(name):
    from portbench import traffic
    return dict(traffic.load(name), batch=4, seq_len=16)


def run(cell, conf, mix, fault=None):
    return harness.run_cell(cell, 2**31 + 99, 0.0, False, started=time.perf_counter(),
                            device="cpu", fault=fault, conf=conf, mix=mix)


SERVE_CELLS = ["ds7b.agent_turn", "ds7b.rag_synth"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("fault", [None, alter_first_token, alter_a_decoded_token],
                         ids=["sound", "first_token", "decoded_token"])
def test_serve_faults(cell, fault):
    if cell not in [c["name"] for c in harness.manifest()["workloads"]]:
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    got = run(cell, DENSE, SERVE, fault)
    assert got["correct"] is (fault is None), got["checks"]


TRAIN_CELLS = [("moe16b.finetune", MOE, "finetune.4x4096"),
               ("ds7b.finetune", DENSE, "finetune.2x4096")]


@pytest.mark.parametrize("cell,conf,mix", TRAIN_CELLS, ids=[c[0] for c in TRAIN_CELLS])
@pytest.mark.parametrize("fault", [None, unchanged_state, half_the_batch],
                         ids=["sound", "unchanged_state", "half_the_batch"])
def test_train_faults(cell, conf, mix, fault):
    if cell not in [c["name"] for c in harness.manifest()["workloads"]]:
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    got = run(cell, conf, train_mix(mix), fault)
    assert got["correct"] is (fault is None), got["checks"]
