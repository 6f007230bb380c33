"""LeoAM in PyTorch for NVIDIA Hopper.

The port of the JAX package ``repro`` (which stays the reference): the
same module names, the same parameter tree, the same tier store and
engine, with a hand-written CUDA kernel where ``repro`` had a Pallas one
(``repro_torch.kernels``).  The package imports ``torch``, ``numpy`` and
the standard library only — never ``jax`` and never ``repro``.

Every entry point takes ``device=`` and defaults to the CUDA card; without
one it raises rather than running on the CPU (:func:`resolve_device`).
"""

from repro_torch.device import resolve_device  # noqa: F401
