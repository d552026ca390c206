"""The plain reference held to repro_torch at reduced sizes on the CPU,
both in fp32 so that they agree to rounding: the dense and MoE decoders'
full forward, prefill then decode through a cache, and a train step with
AdamW."""
import copy

import pytest
import torch

from portbench import weights
from portbench.harness import Context
from portbench.reference import decoder
from portbench.reference import train as ref_train
from portbench.reference.common import forward_logits, leaves

DENSE = {"name": "tiny", "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
         "n_kv_heads": 2, "d_ff": 96, "vocab_size": 128, "rope_theta": 10000.0,
         "tie_embeddings": False, "param_dtype": "float32", "activ_dtype": "float32"}
MOE = {"name": "tinymoe", "family": "moe", "n_layers": 3, "d_model": 64, "n_heads": 4,
       "n_kv_heads": 4, "d_ff": 0, "vocab_size": 128, "tie_embeddings": False,
       "param_dtype": "float32", "activ_dtype": "float32",
       "moe": {"num_experts": 8, "top_k": 2, "num_shared": 2, "d_ff_expert": 16,
               "capacity_factor": 64.0, "router_aux_coef": 0.01, "first_k_dense": 1,
               "d_ff_dense": 96}}
OPT = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "grad_clip": 1.0, "moment_dtype": "float32", "warmup_steps": 0, "total_steps": 100}


def program(model):
    from repro_torch.models.model_zoo import build_model
    m = build_model(Context({}, {"model": model}, {}, 0, 0, None, None, 0).program_config())
    return m, weights.draw(m.specs, 11, "cpu", torch.float32)


@pytest.mark.parametrize("model", [DENSE, MOE], ids=["dense", "moe"])
def test_full_forward(model):
    m, params = program(model)
    tokens = torch.randint(0, 128, (2, 24), generator=torch.Generator().manual_seed(1))
    theirs, _, _ = m.apply(params, {"tokens": tokens}, mode="train")
    ours = forward_logits(decoder, params, model, tokens)
    torch.testing.assert_close(ours, theirs, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", [DENSE, MOE], ids=["dense", "moe"])
def test_prefill_then_decode_through_the_cache(model):
    from repro_torch.runtime.serve import ServeSession
    m, params = program(model)
    prompts = torch.randint(0, 128, (3, 10), generator=torch.Generator().manual_seed(2))
    theirs = ServeSession(m, params, device="cpu").generate(prompts, 6)
    ours, logits = decoder.generate(params, model, prompts, 6)
    assert torch.equal(ours, theirs)
    # the cache path gives the full forward's logits at each produced position
    full = forward_logits(decoder, params, model, torch.cat([prompts, ours[:, :-1]], 1),
                          torch.arange(9, 15))
    torch.testing.assert_close(logits, full, rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_as_the_program():
    """With a capacity of 1.0 some experts drop assignments; both keep the
    first ones in token order (the router keeps every token off the last
    expert, where the program mirrors a slot quirk of the JAX package)."""
    from repro_torch.models import moe as pmoe
    model = copy.deepcopy(MOE)
    model["moe"]["capacity_factor"] = 1.0
    m, params = program(model)
    p = {k: v[0] for k, v in params["groups"]["g1"]["b1"]["moe"].items()
         if k != "shared"}
    p["shared"] = {k: v[0] for k, v in params["groups"]["g1"]["b1"]["moe"]["shared"].items()}
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(3))
    x[:, 0] = 10.0
    p["router"][:, -1] = 0.0
    p["router"][0, -1] = -50.0
    cfg = m.cfg
    theirs, aux_t = pmoe.apply_moe(p, x[None], cfg=cfg)
    ours, aux_o = decoder.moe_block(p, x, model["moe"])
    counts = torch.bincount(torch.sort(torch.softmax(x @ p["router"], -1), dim=-1,
                                       descending=True, stable=True)[1][:, :2].reshape(-1),
                            minlength=8)
    assert int(counts.max()) > decoder.capacity(40, model["moe"])    # something dropped
    torch.testing.assert_close(ours, theirs[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(aux_o, aux_t, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("model", [DENSE, MOE], ids=["dense", "moe"])
def test_train_step(model):
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train import TrainOptions, build_train_step
    m, params = program(model)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, 128, (2, 16), generator=g)
    labels = torch.randint(0, 128, (2, 16), generator=g)
    opt = AdamWConfig(**{k: OPT[k] for k in ("lr", "b1", "b2", "eps", "weight_decay",
                                             "grad_clip", "moment_dtype")})
    opts = TrainOptions(remat_policy="full", opt=opt, warmup_steps=0, total_steps=100)
    ours_p = copy.deepcopy(params)
    state = {"params": params, "opt": adamw.init_opt_state(params, opt),
             "step": torch.zeros((), dtype=torch.int32)}
    step = build_train_step(m, opts)
    losses = []
    for _ in range(2):
        state, metrics = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(metrics["loss"]))
    got = ref_train.train_steps(decoder, ours_p, model, [(tokens, labels)] * 2, OPT)
    assert got["loss"] == pytest.approx(losses, rel=1e-5)
    theirs = leaves(state["params"])
    for path, t in leaves(ours_p).items():
        torch.testing.assert_close(t, theirs[path], rtol=1e-4, atol=1e-6)
