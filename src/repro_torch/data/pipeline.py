"""Deterministic synthetic data pipeline (resumable).

Counterpart of ``repro.data.pipeline``: the batches are drawn by numpy
exactly as the reference draws them, so they are bitwise the reference's;
only the outputs become torch tensors, on the device asked for. Batch
content is a pure function of (seed, step), so a restarted job resumes
bit-identically from a checkpointed step.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._bridge import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Markov-ish synthetic text: next token depends on previous (so the loss
    # actually decreases during training)
    structure: float = 0.7


def batch_for_step(cfg: DataConfig, step: int, model_cfg=None,
                   batch: int | None = None, *, device=None) -> dict:
    """The batch of ``step``: int32 ``tokens`` and ``labels`` (B, seq_len);
    bf16 ``frames`` for the encoder-decoder and ``patches`` for the VLM,
    rounded from the same fp32 draws. On ``device`` (``None``: ``cuda``)."""
    dev = resolve_device(device)
    b = batch or cfg.global_batch
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    toks = rng.integers(0, cfg.vocab_size, size=(b, cfg.seq_len + 1),
                        dtype=np.int32)
    if cfg.structure > 0:
        # structured component: t_{i+1} = (a*t_i + c) % V on masked positions
        mask = rng.random((b, cfg.seq_len)) < cfg.structure
        nxt = (toks[:, :-1] * 31 + 7) % cfg.vocab_size
        toks[:, 1:] = np.where(mask, nxt, toks[:, 1:])
    out = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])).to(dev),
           "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])).to(dev)}
    if model_cfg is not None and model_cfg.family == "encdec":
        frames = rng.standard_normal((b, cfg.seq_len, model_cfg.d_model),
                                     dtype=np.float32)
        out["frames"] = torch.from_numpy(frames).to(dev, torch.bfloat16)
    if model_cfg is not None and model_cfg.family == "vlm":
        v = model_cfg.vision
        patches = rng.standard_normal((b, v.num_patches, v.d_vision),
                                      dtype=np.float32)
        out["patches"] = torch.from_numpy(patches).to(dev, torch.bfloat16)
    return out


class DataIterator:
    """Stateful wrapper with an explicit, checkpointable step cursor."""

    def __init__(self, cfg: DataConfig, model_cfg=None, start_step: int = 0,
                 *, device=None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.step = start_step
        self.device = resolve_device(device)

    def __next__(self):
        b = batch_for_step(self.cfg, self.step, self.model_cfg,
                           device=self.device)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict):
        self.step = int(state["step"])
