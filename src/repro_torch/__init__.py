"""PyTorch/CUDA port of the ``repro`` model-serving path.

A package beside ``repro`` (the JAX reference) with the same layout and
module names. It imports ``torch`` and nothing of ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
hand-written Hopper kernels live under ``csrc/`` and are built on first use.
"""
