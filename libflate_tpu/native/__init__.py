"""Native (C++) host engine loader.

Builds ``libflate_native.so`` on first use with g++ (no pybind11 in the
image — plain C ABI via ctypes).  All entry points degrade gracefully:
``available()`` is False when the toolchain or the build is missing, and
the backend registry then falls back to the serial engine.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).parent
_SRC = _DIR / "libflate_native.cpp"
# Binary name carries a content hash of the source: a stale or
# foreign-machine .so (built with -march=native elsewhere) never loads.
_SRC_HASH = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
_SO = _DIR / f"libflate_native-{_SRC_HASH}.so"
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> bool:
    try:
        for stale in _DIR.glob("libflate_native*.so"):
            if stale != _SO:
                try:
                    stale.unlink()
                except OSError:
                    pass
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", str(_SO)],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _SO.exists():
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            _build_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.lf_crc32.restype = ctypes.c_uint32
        lib.lf_crc32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.lf_adler32.restype = ctypes.c_uint32
        lib.lf_adler32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.lf_inflate.restype = ctypes.c_int
        lib.lf_inflate.argtypes = [u8p, ctypes.c_uint64, u8p,
                                   ctypes.c_uint64, u64p, u64p]
        lib.lf_deflate_greedy.restype = ctypes.c_int
        lib.lf_deflate_greedy.argtypes = [u8p, ctypes.c_uint64, u8p,
                                          ctypes.c_uint64, u64p,
                                          ctypes.c_uint64, ctypes.c_int]
        lib.lf_deflate3.restype = ctypes.c_int
        lib.lf_deflate3.argtypes = [u8p, ctypes.c_uint64, u8p,
                                    ctypes.c_uint64, u64p,
                                    ctypes.c_uint64, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
        lib.lf_parse_dyn_headers.restype = ctypes.c_int
        lib.lf_parse_dyn_headers.argtypes = [u8p, u64p, ctypes.c_int32,
                                             i32p, i32p, i64p, i32p]
        lib.lf_splice.restype = ctypes.c_int
        lib.lf_splice.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64,
                                  i64p, u8p, ctypes.c_uint64, u64p]
        lib.lf_inflate_batch.restype = ctypes.c_int
        lib.lf_inflate_batch.argtypes = [u8p, u64p, ctypes.c_int32, u8p,
                                         u64p, u32p, ctypes.c_int32]
        lib.lf_pgzf_index.restype = ctypes.c_int64
        lib.lf_pgzf_index.argtypes = [u8p, ctypes.c_uint64, u64p, u64p,
                                      u32p, u64p, ctypes.c_int64]
        lib.lf_inflate_batch_at.restype = ctypes.c_int
        lib.lf_inflate_batch_at.argtypes = [u8p, u64p, u64p, ctypes.c_int32,
                                            u8p, u64p, u32p, ctypes.c_int32]
        lib.lf_expand_batch.restype = ctypes.c_int
        lib.lf_expand_batch.argtypes = [i32p, i32p, ctypes.c_int64, i64p,
                                        ctypes.c_int32, u8p, u64p, u32p,
                                        ctypes.c_int32, ctypes.c_int32]
        lib.lf_inflate_tokens_batch.restype = ctypes.c_int
        lib.lf_inflate_tokens_batch.argtypes = [
            u8p, u64p, u64p, ctypes.c_int32, i32p, ctypes.c_int64,
            i64p, u64p, ctypes.c_int32]
        lib.lf_inflate_tokens.restype = ctypes.c_int
        lib.lf_inflate_tokens.argtypes = [u8p, ctypes.c_uint64, i32p,
                                          ctypes.c_int64, i64p, u64p,
                                          u64p]
        lib.lf_deflate_batch.restype = ctypes.c_int
        lib.lf_deflate_batch.argtypes = [u8p, u64p, ctypes.c_int32, u8p,
                                         ctypes.c_uint64, u64p, u32p,
                                         ctypes.c_uint64, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crc32(data: bytes, crc: int = 0) -> int:
    lib = load()
    arr = np.frombuffer(bytes(data), np.uint8)
    if len(arr) == 0:
        arr = np.zeros(1, np.uint8)
        return int(lib.lf_crc32(_as_u8p(arr), 0, crc))
    return int(lib.lf_crc32(_as_u8p(arr), len(data), crc))


def adler32(data: bytes, adler: int = 1) -> int:
    lib = load()
    arr = np.frombuffer(bytes(data), np.uint8)
    if len(arr) == 0:
        arr = np.zeros(1, np.uint8)
        return int(lib.lf_adler32(_as_u8p(arr), 0, adler))
    return int(lib.lf_adler32(_as_u8p(arr), len(data), adler))


_ERRORS = {
    -1: "unexpected end of stream",
    -2: "HDIST too big",
    -3: "invalid Huffman code",
    -4: "repeat code 16 with no previous length",
    -5: "code-length repeat overflows table",
    -6: "end-of-block symbol has no code",
    -7: "stored block LEN/NLEN mismatch",
    -8: "output capacity exceeded",
    -9: "reserved block type 0b11",
    -10: "invalid length symbol",
    -11: "invalid distance symbol",
    -12: "back-pointer distance exceeds decoded history",
}


def inflate(data: bytes, initial_cap: int | None = None):
    """Fast serial inflate.  Returns (bytes, end_bit)."""
    from ..serial.deflate import DeflateError
    lib = load()
    src = np.frombuffer(bytes(data) + b"\x00", np.uint8)  # non-empty ptr
    cap = initial_cap or max(8 * len(data) + 4096, 1 << 18)
    for _ in range(8):
        dst = np.empty(cap, np.uint8)
        out_n = ctypes.c_uint64()
        end_bit = ctypes.c_uint64()
        rc = lib.lf_inflate(_as_u8p(src), len(data), _as_u8p(dst), cap,
                            ctypes.byref(out_n), ctypes.byref(end_bit))
        if rc == -8:
            cap *= 4
            continue
        if rc == -1:
            raise EOFError(_ERRORS[-1])
        if rc < 0:
            raise DeflateError(_ERRORS.get(rc, f"native error {rc}"))
        return dst[:out_n.value].tobytes(), int(end_bit.value)
    raise DeflateError("output too large")


def deflate_greedy(data: bytes, block_size: int = 1 << 20,
                   final: bool = True, lazy: bool = False,
                   max_chain: int = 1) -> bytes:
    lib = load()
    src = np.frombuffer(bytes(data) + b"\x00", np.uint8)
    cap = len(data) + len(data) // 2 + 4096 + 400 * (len(data) // block_size + 1)
    dst = np.empty(cap, np.uint8)
    out_n = ctypes.c_uint64()
    rc = lib.lf_deflate3(_as_u8p(src), len(data), _as_u8p(dst), cap,
                         ctypes.byref(out_n), block_size,
                         1 if final else 0, 1 if lazy else 0, max_chain)
    if rc:
        raise RuntimeError(f"native deflate failed: {rc}")
    return dst[:out_n.value].tobytes()


def parse_dyn_headers(bodies: bytes, offsets: np.ndarray):
    """Batch-parse member block headers.

    Returns (lit_lengths (B,288), dist_lengths (B,30), start_bits (B,),
    flags (B,)).  Raises DeflateError with the member index on failure.
    The 288-wide literal rows carry the full fixed alphabet.
    """
    from ..serial.deflate import DeflateError
    lib = load()
    b = len(offsets) - 1
    buf = np.frombuffer(bytes(bodies) + b"\x00", np.uint8)
    offs = np.ascontiguousarray(offsets, np.uint64)
    lit = np.zeros((b, 288), np.int32)
    dist = np.zeros((b, 30), np.int32)
    starts = np.zeros(b, np.int64)
    flags = np.zeros(b, np.int32)
    rc = lib.lf_parse_dyn_headers(
        _as_u8p(buf), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b, lit.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        member = (-rc) // 100
        raise DeflateError(f"bad block header in member {member}")
    return lit, dist, starts, flags


def inflate_batch(bodies: bytes, offsets: np.ndarray,
                  out_sizes: np.ndarray, n_threads: int = 0):
    """Decode independent DEFLATE bodies in parallel (thread pool).

    offsets: (B+1,) uint64 extents into ``bodies``; out_sizes: (B,)
    expected output sizes (gzip ISIZE).  Returns (out bytes, crcs (B,)).
    Raises DeflateError naming the failing member.
    """
    from ..serial.deflate import DeflateError
    lib = load()
    b = len(offsets) - 1
    buf = np.frombuffer(bytes(bodies) + b"\x00", np.uint8)
    offs = np.ascontiguousarray(offsets, np.uint64)
    out_offs = np.zeros(b + 1, np.uint64)
    np.cumsum(np.asarray(out_sizes, np.uint64), out=out_offs[1:])
    out = np.empty(int(out_offs[-1]) + 1, np.uint8)
    crcs = np.zeros(b, np.uint32)
    rc = lib.lf_inflate_batch(
        _as_u8p(buf), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b, _as_u8p(out),
        out_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_threads)
    if rc < 0:
        raise DeflateError(f"decode failed in member {-rc - 1}")
    return out[: int(out_offs[-1])].tobytes(), crcs


def pgzf_index(data: bytes):
    """Walk a PGZF stream's LF member index in C.

    Returns ``(body_starts, body_ends, crcs, isizes)`` uint64/uint32
    arrays, or ``None`` when any member is malformed or lacks the index
    (caller falls back to the generic Python header walk).
    """
    lib = load()
    buf = np.frombuffer(bytes(data), np.uint8)
    # minimal indexed member: 10B header + 8B EXTRA + >=2B body + 8B trailer
    max_members = len(buf) // 28 + 1
    starts = np.zeros(max_members, np.uint64)
    ends = np.zeros(max_members, np.uint64)
    crcs = np.zeros(max_members, np.uint32)
    isizes = np.zeros(max_members, np.uint64)
    cnt = lib.lf_pgzf_index(
        _as_u8p(buf), len(buf),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        isizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), max_members)
    if cnt < 0:
        return None
    return starts[:cnt], ends[:cnt], crcs[:cnt], isizes[:cnt]


def inflate_batch_at(data: bytes, body_starts: np.ndarray,
                     body_ends: np.ndarray, out_sizes: np.ndarray,
                     n_threads: int = 0):
    """Decode members sitting at [starts, ends) inside ``data`` without
    copying the payloads out first.  Returns (out bytes, crcs)."""
    from ..serial.deflate import DeflateError
    lib = load()
    b = len(body_starts)
    buf = np.frombuffer(bytes(data), np.uint8)
    starts = np.ascontiguousarray(body_starts, np.uint64)
    ends = np.ascontiguousarray(body_ends, np.uint64)
    out_offs = np.zeros(b + 1, np.uint64)
    np.cumsum(np.asarray(out_sizes, np.uint64), out=out_offs[1:])
    out = np.empty(int(out_offs[-1]) + 1, np.uint8)
    crcs = np.zeros(b, np.uint32)
    rc = lib.lf_inflate_batch_at(
        _as_u8p(buf),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b, _as_u8p(out),
        out_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_threads)
    if rc < 0:
        raise DeflateError(f"decode failed in member {-rc - 1}")
    return out[: int(out_offs[-1])].tobytes(), crcs


def inflate_tokens_batch(data: bytes, body_starts, body_ends,
                         token_cap: int, n_threads: int = 0):
    """Decode member bodies into packed LZ77 tokens (no expansion).

    The foreign-stream device-decode bridge: per-member dynamic (or
    fixed/stored) blocks whose tables cannot ride the shared-table sync
    decoder are entropy-decoded here — the sequential phase — and the
    tokens feed the device expansion + CRC chain
    (formats/pgzf._foreign_to_device).

    Returns (toks (B, token_cap) int32 packed a | b << 9,
    counts (B,) int64, out_sizes (B,) uint64).
    """
    from ..serial.deflate import DeflateError
    lib = load()
    b = len(body_starts)
    buf = np.frombuffer(bytes(data), np.uint8)
    starts = np.ascontiguousarray(body_starts, np.uint64)
    ends = np.ascontiguousarray(body_ends, np.uint64)
    toks = np.empty((b, token_cap), np.int32)
    counts = np.zeros(b, np.int64)
    osz = np.zeros(b, np.uint64)
    rc = lib.lf_inflate_tokens_batch(
        _as_u8p(buf),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b, toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        token_cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        osz.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n_threads)
    if rc < 0:
        raise DeflateError(f"token decode failed in member {-rc - 1}")
    return toks, counts, osz


def inflate_tokens(data: bytes, start: int, token_cap: int):
    """Decode ONE member body (starting at byte ``start``) to packed
    tokens, reporting the end bit so callers can walk un-indexed
    multi-member streams.  Returns (toks (n,) int32, out_size, end_bit)
    or None when ``token_cap`` was too small (grow and retry)."""
    from ..serial.deflate import DeflateError
    lib = load()
    buf = np.frombuffer(bytes(data), np.uint8)
    toks = np.empty(token_cap, np.int32)
    tn = np.zeros(1, np.int64)
    osz = np.zeros(1, np.uint64)
    eb = np.zeros(1, np.uint64)
    rc = lib.lf_inflate_tokens(
        _as_u8p(buf[start:]), len(data) - start,
        toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), token_cap,
        tn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        osz.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        eb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    if rc == -8:
        return None
    if rc < 0:
        raise DeflateError(f"token decode failed (rc {rc})")
    return toks[:int(tn[0])], int(osz[0]), int(eb[0])


def deflate_batch(data: bytes, chunk_offsets: np.ndarray,
                  block_size: int = 1 << 20, n_threads: int = 0,
                  lazy: bool = False, max_chain: int = 1):
    """Encode chunks of ``data`` as independent DEFLATE streams in
    parallel.  Returns (list of compressed bodies, crcs (B,))."""
    lib = load()
    b = len(chunk_offsets) - 1
    buf = np.frombuffer(bytes(data) + b"\x00", np.uint8)
    offs = np.ascontiguousarray(chunk_offsets, np.uint64)
    max_chunk = int(np.max(offs[1:] - offs[:-1], initial=1))
    stride = max_chunk + max_chunk // 2 + 4096
    dst = np.empty(b * stride, np.uint8)
    sizes = np.zeros(b, np.uint64)
    crcs = np.zeros(b, np.uint32)
    rc = lib.lf_deflate_batch(
        _as_u8p(buf), offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        b, _as_u8p(dst), stride,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        block_size, n_threads, 1 if lazy else 0, max_chain)
    if rc < 0:
        raise RuntimeError(f"encode failed in member {-rc - 1}")
    bodies = [dst[i * stride: i * stride + int(sizes[i])].tobytes()
              for i in range(b)]
    return bodies, crcs


def expand_batch(a: np.ndarray, b: np.ndarray | None, counts: np.ndarray,
                 out_sizes: np.ndarray, n_threads: int = 0):
    """Expand LZ77 token batches (threaded) and CRC each output.

    a/b: (B, T) int32 tokens, or b=None with ``a`` holding packed
    tokens (a | b<<9); counts: (B,); out_sizes: (B,) expected output
    bytes.  Returns (out bytes, crcs (B,)).
    """
    from ..serial.deflate import DeflateError
    lib = load()
    bsz, stride = a.shape
    a = np.ascontiguousarray(a, np.int32)
    packed = 1 if b is None else 0
    b_arr = a if b is None else np.ascontiguousarray(b, np.int32)
    counts64 = np.ascontiguousarray(counts, np.int64)
    out_offs = np.zeros(bsz + 1, np.uint64)
    np.cumsum(np.asarray(out_sizes, np.uint64), out=out_offs[1:])
    out = np.empty(int(out_offs[-1]) + 1, np.uint8)
    crcs = np.zeros(bsz, np.uint32)
    rc = lib.lf_expand_batch(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stride,
        counts64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bsz, _as_u8p(out),
        out_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_threads,
        packed)
    if rc < 0:
        raise DeflateError(f"token expansion failed in member {-rc - 1}")
    return out[: int(out_offs[-1])].tobytes(), crcs


def splice(words: np.ndarray, bits: np.ndarray) -> bytes:
    """Native bit-splice of (B, W) uint32 rows with per-row bit counts."""
    lib = load()
    words = np.ascontiguousarray(words, np.uint32)
    bits64 = np.ascontiguousarray(bits, np.int64)
    total_bits = int(bits64.sum())
    cap = total_bits // 8 + 64
    dst = np.zeros(cap, np.uint8)
    out_bits = ctypes.c_uint64()
    rc = lib.lf_splice(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        words.shape[0], words.shape[1],
        bits64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _as_u8p(dst), cap, ctypes.byref(out_bits))
    if rc:
        raise RuntimeError(f"native splice failed: {rc}")
    return dst[: (int(out_bits.value) + 7) // 8].tobytes()
