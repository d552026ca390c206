"""Device choice, and weights and train states carried across from the
JAX package.

``params_from_numpy`` turns a parameter pytree that was flattened to numpy
(``jax.tree.map(np.asarray, params)``) into the port's tensors, path by path,
with identical keys and shapes; ``params_to_numpy`` is its inverse. The two
packages draw different random bits from the same seed, so parity tests run
both on weights converted here. The two carry a whole train state the same
way (any nested dict of arrays): params, the AdamW moments (int8 ``{"q",
"scale"}`` pairs included), ``count`` and ``step``, so that both packages
can train from one state.

numpy has no bf16 of its own: a bf16 array (``dtype.name == "bfloat16"``,
as ``ml_dtypes`` defines it) crosses as its raw 16-bit pattern. The port
never imports ``ml_dtypes``; the way back to numpy's bf16 type needs it to
have been imported by the caller (JAX does), and raises otherwise.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; asking for a card that is absent raises.

    Entry points call this so that a missing card is an error, never a
    silent run on the CPU: the CPU is used only when the caller asks for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.array(a)   # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        # same 16 bits, reinterpreted; int16 is the bit container torch
        # converts from numpy on every version
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``
    (``None`` means ``cuda``, see :func:`resolve_device`)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor_from_numpy(tree).to(device)


def _numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")   # registered by ml_dtypes
        except TypeError as err:
            raise TypeError("numpy has no bfloat16 until ml_dtypes (which "
                            "JAX imports) is imported") from err
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: tensors -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return _numpy_from_tensor(tree)
