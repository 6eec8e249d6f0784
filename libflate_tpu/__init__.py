"""libflate_tpu — a DEFLATE/ZLIB/GZIP compression framework for accelerators.

A from-scratch reimplementation of the capability surface of sile/libflate
(RFC-1951/1950/1952 codecs) designed for data parallelism: array-in/array-out,
block-parallel, table-driven and branchless on the device path
(JAX/XLA/Pallas), with serial-Python and C++ host engines for oracle and
host-side work.

Public modules (parity: reference src/lib.rs:40-50):
    deflate, gzip, zlib, lz77, finish, chunked (≙ non_blocking)
"""
from . import backend
from . import finish as finish  # noqa: PLC0414
from .finish import AutoFinish, AutoFinishUnchecked, Finish
from .formats import deflate, gzip, zlib
from . import lz77

try:                                    # native C++ host engine (optional)
    from .native import engine as _native_engine  # noqa: F401
except Exception:                       # pragma: no cover - toolchain absent
    pass

__version__ = "0.1.0"

__all__ = [
    "backend", "deflate", "gzip", "zlib", "lz77", "finish",
    "Finish", "AutoFinish", "AutoFinishUnchecked",
]
