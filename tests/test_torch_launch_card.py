"""The launchers' reduced configs on the card (``repro_torch.launch.card``).

A reduced config's head dim is 16, which no flash kernel takes, so on the
card the launchers run ``card_config``'s: heads of 64. Each arch's card
config is traced on meta tensors (the wrappers' meta paths check what the
kernels take, and launch nothing): a train step, a prefill and a decode
step, in bf16, call the forward and backward kernels with head dims both
take; the reduced config's own trace raises where the card's kernel would.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.card import card_config, launch_config  # noqa: E402

HEAD_FIELDS = {"n_heads", "n_kv_heads", "head_dim"}
KINDS = ("train", "prefill", "decode")


def _changed(a, b) -> set:
    return {f.name for f in dataclasses.fields(a)
            if getattr(a, f.name) != getattr(b, f.name)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_config_changes_the_heads_alone(arch):
    """Every field but the attention heads is the reduced config's; an
    attention-free config is returned as it is."""
    reduced = get_config(arch, reduced=True)
    card = card_config(reduced)
    assert _changed(reduced, card) <= HEAD_FIELDS
    assert card.d_model == reduced.d_model
    if reduced.is_attention_free:
        assert card is reduced
    else:
        assert card.head_dim_ in fa.HEAD_DIMS and card.head_dim_ in fa.BWD_HEAD_DIMS
        assert card.n_heads * card.head_dim_ <= card.d_model
        assert card.n_heads % card.n_kv_heads == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_card_config_every_attention_call_takes_the_kernels(arch, monkeypatch):
    """A train step, a prefill and a decode step of the card config on meta
    tensors: every forward and backward flash call (self, cross, encoder,
    the VLM's, the hybrid's shared block) has a head dim in HEAD_DIMS and
    BWD_HEAD_DIMS, in bf16 (the wrappers check both); the reduced config's
    train step raises at the first attention call instead."""
    reduced = get_config(arch, reduced=True)
    card = card_config(reduced)
    seen = []
    check = fa.check_inputs

    def record(q, k, v):
        seen.append((q.shape[-1], q.dtype))
        return check(q, k, v)

    monkeypatch.setattr(fa, "check_inputs", record)
    calls = {}
    for kind in KINDS:
        summary = dryrun.lower_cell(card, ShapeCell(kind, 32, 2, kind)) \
            .census.summary()
        calls[kind] = summary["kernel_calls"]
    if reduced.is_attention_free:
        assert not seen
        return
    assert calls["train"].get("flash_attention_bwd", 0) > 0
    assert calls["prefill"].get("flash_attention", 0) > 0
    assert {d for d, _ in seen} <= set(fa.HEAD_DIMS) & set(fa.BWD_HEAD_DIMS)
    assert {dt for _, dt in seen} == {torch.bfloat16}
    with pytest.raises(ValueError, match=f"head_dim {reduced.head_dim_} "):
        dryrun.lower_cell(reduced, ShapeCell("train", 32, 2, "train"))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_config_applies_on_the_card_alone(arch):
    """The launchers' config: the reference's reduced one on the CPU (the
    CPU tests compare equal configs) and at full width anywhere; the card
    config for a reduced run on the card, with a line saying so."""
    reduced = get_config(arch, reduced=True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    said = []
    got = launch_config(reduced, reduced=True, device=cpu, tag="t",
                        say=said.append)
    assert got is reduced and said == []
    full = get_config(arch)
    got = launch_config(full, reduced=False, device=cuda, tag="t",
                        say=said.append)
    assert got is full and said == []
    assert card_config(full) is full      # every full config's heads fit
    card = launch_config(reduced, reduced=True, device=cuda, tag="t",
                         say=said.append)
    assert card == card_config(reduced)
    assert len(said) == (0 if reduced.is_attention_free else 1)
    if said:
        assert said[0].startswith(f"[t] {arch} reduced on the card: ")


def test_the_restart_phase_config_is_the_card_config():
    """``chip_smoke.py``'s restart phase ran deepseek-7b REDUCED with one
    head of 64 and one KV head: the card config is that config."""
    reduced = get_config("deepseek-7b", reduced=True)
    assert card_config(reduced) == reduced.replace(n_heads=1, n_kv_heads=1)
