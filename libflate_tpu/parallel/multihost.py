"""Multi-host PGZF: member sharding over DCN via ``jax.distributed``.

SURVEY §2.3.5 / §5 distribution model, scaled past one host:

* **Slab partition** — the input is split into per-process slabs on
  member_size boundaries, so every gzip member is wholly owned by one
  process (per-member LZ77 reset keeps them independent; no halo).
* **Local encode** — each process runs its own engine (native threads
  or the device pipeline) over its slab; intra-host parallelism is
  unchanged.
* **Ordered gather** — variable-length member bytes are exchanged with
  ``multihost_utils.process_allgather`` (DCN collectives), then
  concatenated in process order: byte-identical to a single-host
  encode of the same data with the same engine.
* **Checksum folding** — per-member CRCs combine with the GF(2)
  ``crc32_combine`` operator, so a whole-corpus checksum needs no
  re-scan on any single host (log-depth fold, DCN-friendly).

The same entry points run single-process (process_count == 1) without
``jax.distributed`` — the gather degenerates to identity — so CPU CI
exercises the full code path and a 2-process pytest validates the
real multi-process wiring.
"""
from __future__ import annotations

import numpy as np

from ..formats import pgzf
from ..utils.checksum import crc32_combine


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """Initialize jax.distributed (idempotent per process)."""
    import jax
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def _process_info():
    import jax
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def slab_bounds(total: int, member_size: int, pid: int, n: int
                ) -> tuple[int, int]:
    """Contiguous per-process slab, aligned to member boundaries."""
    n_members = max(1, -(-total // member_size))
    per = -(-n_members // n)
    lo = min(pid * per * member_size, total)
    hi = min((pid + 1) * per * member_size, total)
    return lo, hi


def _allgather_bytes(local: bytes) -> list[bytes]:
    """Ordered gather of one variable-length byte string per process."""
    pid, n = _process_info()
    if n == 1:
        return [local]
    from jax.experimental import multihost_utils

    lengths = multihost_utils.process_allgather(
        np.asarray([len(local)], np.int64))
    lengths = np.asarray(lengths).reshape(-1)
    pad = int(lengths.max())
    buf = np.zeros((pad,), np.uint8)
    buf[:len(local)] = np.frombuffer(local, np.uint8)
    gathered = multihost_utils.process_allgather(buf)
    gathered = np.asarray(gathered).reshape(n, pad)
    return [gathered[i, :int(lengths[i])].tobytes() for i in range(n)]


def compress_multihost(data: bytes,
                       member_size: int = pgzf.DEFAULT_MEMBER_SIZE,
                       engine: str | None = None,
                       n_threads: int = 0) -> bytes:
    """Member-sharded encode across all JAX processes.

    Every process receives the full ``data`` (caller-distributed input,
    e.g. a shared filesystem), compresses only its slab, and the
    ordered allgather returns the complete stream on every process —
    byte-identical to single-host ``pgzf.compress`` with that engine.
    """
    pid, n = _process_info()
    lo, hi = slab_bounds(len(data), member_size, pid, n)
    local = (pgzf.compress(data[lo:hi], member_size=member_size,
                           engine=engine, n_threads=n_threads)
             if hi > lo else b"")
    return b"".join(_allgather_bytes(local))


def decompress_multihost(stream: bytes,
                         engine: str | None = None,
                         n_threads: int = 0) -> bytes:
    """Member-sharded decode: each process inflates a contiguous run of
    members; the ordered allgather reassembles the plaintext."""
    pid, n = _process_info()
    refs = pgzf.index_members(stream)
    if refs is None:
        # non-indexed stream: no boundary discovery without decoding —
        # fall back to a single-host decode on every process
        return pgzf.decompress(stream, engine=engine, n_threads=n_threads)
    per = -(-len(refs) // n)
    mine = refs[pid * per:(pid + 1) * per]
    local = b""
    if mine:
        piece = stream[mine[0].start:mine[-1].end]
        local = pgzf.decompress(piece, engine=engine, n_threads=n_threads)
    return b"".join(_allgather_bytes(local))


def corpus_crc32_multihost(data: bytes,
                           member_size: int = pgzf.DEFAULT_MEMBER_SIZE
                           ) -> int:
    """Whole-corpus CRC-32 via per-slab CRCs + GF(2) combine across
    hosts — no process touches bytes outside its slab."""
    from .. import backend
    pid, n = _process_info()
    lo, hi = slab_bounds(len(data), member_size, pid, n)
    eng = backend.get(None)
    local_crc = eng.crc32(data[lo:hi]) if hi > lo else 0
    parts = _allgather_bytes(
        np.asarray([local_crc, hi - lo], np.uint64).tobytes())
    crc, total = 0, 0
    for blob in parts:
        c, ln = np.frombuffer(blob, np.uint64)
        crc = crc32_combine(crc, int(c), int(ln)) if total else int(c)
        total += int(ln)
    return crc
