"""The one place that reads which backend JAX runs on.

The device path is plain JAX apart from one Pallas kernel
(ops/sync_decode), which compiles through Triton on the GPU.  There is
no CPU lowering for it, so on the CPU it runs in the Pallas interpreter
and the CPU tests execute the same kernel body the card runs.
"""
from __future__ import annotations

import jax


def backend() -> str:
    """JAX's default backend: "gpu", "cpu", ..."""
    return jax.default_backend()


def interpret() -> bool:
    """Whether Pallas kernels run in interpret mode (CPU backend only)."""
    return backend() == "cpu"


def has_accelerator() -> bool:
    """True when the default backend is not the CPU.

    ``engine=None`` / ``"auto"`` entry points prefer the host engines
    when this is False; an explicitly requested device engine runs
    regardless (interpreted on the CPU).
    """
    return not interpret()
