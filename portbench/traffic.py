"""The one traffic generator: it reads a mix's parameters from
``traffic/<mix>.json`` and makes the requests or batches from the seed.

A serve mix (``"kind": "serve"``) is a closed loop of one client sending
batches of ``batch`` requests: batch i has the prompt length
``prompt_lengths[i % len]`` (a fixed cycle, the same for every seed) and
asks for ``new_tokens`` greedy tokens; the prompts' ids are drawn from the
seed on the device. A train mix (``"kind": "train"``) is a stream of
``batch`` x ``seq_len`` token batches: the synthetic Markov-ish text below,
step by step from the seed.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``."""
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if mix.get("kind") not in ("serve", "train"):
        raise ValueError(f"traffic/{name}.json: kind must be serve or train")
    return mix


@dataclass
class Batch:
    index: int
    prompts: torch.Tensor     # (B, S) int64 on the device
    new_tokens: int


class Requests:
    """The serve mix's batches in order, each drawn when asked for."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.mix, self.vocab, self.device = mix, vocab, torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.drawn = 0

    @property
    def cycle(self) -> int:
        return len(self.mix["prompt_lengths"])

    def length(self, i: int) -> int:
        lengths = self.mix["prompt_lengths"]
        return lengths[i % len(lengths)]

    def next(self) -> Batch:
        i = self.drawn
        self.drawn += 1
        prompts = torch.randint(0, self.vocab, (self.mix["batch"], self.length(i)),
                                generator=self.gen, device=self.device)
        return Batch(i, prompts, self.mix["new_tokens"])

    def warmup(self) -> list[Batch]:
        """One batch at each prompt length of the cycle, drawn from a
        generator of its own (the window's ids are not used up)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.gen.initial_seed()) ^ 0x5EED)
        return [Batch(-1 - i, torch.randint(0, self.vocab,
                                            (self.mix["batch"], self.length(i)),
                                            generator=gen, device=self.device),
                      self.mix["warmup_new_tokens"])
                for i in range(self.cycle)]


def train_batch(mix: dict, vocab: int, seed: int, step: int) -> dict:
    """Step ``step``'s batch of the synthetic stream, int32 numpy ``tokens``
    and ``labels`` (B, seq_len): uniform ids where a mask drawn with
    probability ``structure`` is off, else the previous id times 31 plus 7
    modulo the vocabulary, so that a fine-tune's loss falls. A copy of
    ``repro_torch/data/pipeline.py::batch_for_step``'s token stream."""
    b, s, structure = mix["batch"], mix["seq_len"], mix["structure"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, vocab, size=(b, s + 1), dtype=np.int32)
    if structure > 0:
        mask = rng.random((b, s)) < structure
        nxt = (toks[:, :-1] * 31 + 7) % vocab
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
    return {"tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:])}
