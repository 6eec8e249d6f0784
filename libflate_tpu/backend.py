"""Backend registry: which engine runs the raw DEFLATE byte work.

The container layers (gzip/zlib framing) are engine-agnostic.  Three
engines implement the same array-in/array-out contract:

* ``serial``  — pure-Python/numpy oracle (always available, slow)
* ``native``  — C++ host extension (fast single-core host path)
* ``tpu``     — JAX pipeline on the accelerator (block-parallel device
  path; the engine keeps its first device's name)

``auto`` picks the fastest available engine for the request size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class Engine:
    name: str
    #: (data, EncodeOptions) -> compressed bytes (raw DEFLATE stream)
    deflate: Callable
    #: (data) -> InflateResult (with .data bytearray and .end_bit)
    inflate: Callable
    crc32: Callable
    adler32: Callable
    available: Callable[[], bool] = lambda: True


_engines: dict[str, Engine] = {}
_default: Optional[str] = None


def register(engine: Engine, make_default: bool = False) -> None:
    _engines[engine.name] = engine
    global _default
    if make_default or _default is None:
        _default = engine.name


def get(name: str | None = None) -> Engine:
    if name in (None, "auto"):
        # preference order: native > serial for host work; the device
        # engine is opt-in
        for candidate in ("native", "serial"):
            e = _engines.get(candidate)
            if e is not None and e.available():
                return e
        name = _default
    e = _engines.get(name)
    if e is None:
        raise KeyError(f"no such backend engine: {name!r} "
                       f"(registered: {sorted(_engines)})")
    if not e.available():
        raise RuntimeError(f"backend engine {name!r} is not available")
    return e


def names() -> list[str]:
    return sorted(_engines)


def _register_serial() -> None:
    from .serial import deflate as sd
    from .utils import checksum as ck

    register(Engine(
        name="serial",
        deflate=lambda data, opts=None: sd.deflate(bytes(data), opts),
        inflate=lambda data: sd.inflate(bytes(data)),
        crc32=lambda data, crc=0: ck.crc32(bytes(data), crc),
        adler32=lambda data, adler=1: ck.adler32(bytes(data), adler),
    ))


_register_serial()
