"""Faults planted in the program's timed path, for the tests and for
reading a fault's numbers on the card (``control.py --fault``): each takes
the session or the step and returns it broken."""
from __future__ import annotations

import torch

from .reference.common import leaves


def alter_first_token(session):
    """The prefill puts another token first."""
    prefill = session._prefill

    def wrong(*a, **kw):
        last, cache = prefill(*a, **kw)
        rows = torch.arange(last.shape[0], device=last.device)
        other = (torch.argmax(last, -1) + 1) % last.shape[-1]
        last = last.clone()
        last[rows, other] = last.max() + 1.0
        return last, cache
    session._prefill = wrong
    return session


def alter_a_decoded_token(session):
    """Each decode step hands on the next id after the one it chose."""
    decode = session._decode

    def wrong(params, cache, tok, idx, generator=None):
        nxt, last, cache = decode(params, cache, tok, idx)
        return (nxt + 1) % last.shape[-1], last, cache
    session._decode = wrong
    return session


def unchanged_state(step):
    """The step computes, and returns the state it was given. The step
    updates its state in place, so the state waits in host memory (a 7B
    model's weights and moments leave no room for a copy on the card) and
    is written back after it."""
    def wrong(state, batch):
        kept = {p: t.to("cpu", copy=True) for p, t in leaves(state).items()}
        _, metrics = step(state, batch)
        for p, t in leaves(state).items():
            t.copy_(kept[p])
        return state, metrics
    return wrong


def half_the_batch(step):
    """The step takes the first half of the batch's rows, its loss the mean
    over them."""
    def wrong(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return wrong


SERVE = {"first_token": alter_first_token, "decoded_token": alter_a_decoded_token}
TRAIN = {"unchanged_state": unchanged_state, "half_the_batch": half_the_batch}
