"""Device (JAX) CRC-32 and Adler-32 kernels.

Data-parallel design — no byte-serial table walk (the reference relies
on the ``crc32fast``/``adler32`` native crates; SURVEY.md §2.2):

* **CRC-32 is linear over GF(2).**  Split the input into 64-byte chunks.
  Each chunk's contribution is ``V = G · bits(chunk)`` where ``G`` is a
  host-precomputed 512×32 bit matrix — evaluated for all chunks at once
  as one matmul.  Chunk contributions fold in log₂(N) tree levels, each
  level applying a constant 32×32 GF(2) "shift by 64·2^k bytes" matrix —
  again a matmul.  Every product takes int8 0/1 operands with int32
  accumulation (``_gf2_dot``), so it is exact on any backend and at any
  matmul precision setting; parity = the low bit.
* **Adler-32** is two segmented sums with lazy mod-65521 reduction; the
  weighted sum uses a split 16×16-bit modular multiply to stay inside
  int32 (JAX runs without 64-bit integers by default).

Both are exact (bit-identical to zlib) and jittable on any backend.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec.constants import ADLER32_MOD
from ..utils.checksum import CRC_TABLE, _gf2_matrix_times, _shift_operator

# ---------------------------------------------------------------------------
# Host-side constant construction
# ---------------------------------------------------------------------------
CHUNK = 64            # bytes per CRC chunk (512 bits)


def _crc_raw_register(data: np.ndarray) -> int:
    """CRC register after processing ``data`` starting from register 0."""
    c = np.uint32(0)
    for b in data:
        c = CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> np.uint32(8))
    return int(c)


@functools.lru_cache(maxsize=1)
def _chunk_basis_matrix() -> np.ndarray:
    """G: (512, 32) 0/1 matrix; row i = f(chunk with only bit i set).

    Bit i corresponds to byte i//8, bit position i%8 (LSB-first, matching
    CRC byte processing order).
    """
    G = np.zeros((8 * CHUNK, 32), dtype=np.int8)
    for i in range(8 * CHUNK):
        chunk = np.zeros(CHUNK, dtype=np.uint8)
        chunk[i // 8] = 1 << (i % 8)
        v = _crc_raw_register(chunk)
        for o in range(32):
            G[i, o] = (v >> o) & 1
    return G


@functools.lru_cache(maxsize=32)
def _level_matrix(level: int) -> np.ndarray:
    """(32, 32) 0/1 matrix of the shift-by-(CHUNK·2^level)-bytes op.

    Element [j, o] = bit o of A(e_j) so that out = (v_bits @ M) % 2.
    """
    return _cols_matrix(_shift_operator(CHUNK * (1 << level)))


@functools.lru_cache(maxsize=1024)
def _init_term(n: int) -> int:
    """A^n(0xFFFFFFFF): the initial register propagated over n bytes."""
    if n == 0:
        return 0xFFFFFFFF
    return _gf2_matrix_times(_shift_operator(n), 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# CRC-32 device kernel
# ---------------------------------------------------------------------------
def _gf2_dot(x: jnp.ndarray, m) -> jnp.ndarray:
    """x @ m over GF(2) for 0/1 operands: int8 inputs, int32 sums (at
    most 512 terms), parity -> int32 0/1."""
    prod = jax.lax.dot(x.astype(jnp.int8), jnp.asarray(m, jnp.int8),
                       preferred_element_type=jnp.int32)
    return prod & 1


def _bits_of_bytes(chunks: jnp.ndarray) -> jnp.ndarray:
    """(M, 64) uint8 -> (M, 512) int8 of bits, LSB-first per byte."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (chunks[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(chunks.shape[0], -1).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("length",))
def _crc32_padded(chunks: jnp.ndarray, length: int) -> jnp.ndarray:
    """CRC-32 of ``length`` bytes packed (front-zero-padded) into
    (M, 64) uint8 chunks, M a power of two."""
    init = jnp.uint32(_init_term(length))
    return (_crc32_f_padded(chunks) ^ init) ^ jnp.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=())
def _crc32_f_padded(chunks: jnp.ndarray) -> jnp.ndarray:
    """Raw f-value (register from 0) of (M, 64) uint8 chunks, M = 2^k."""
    v = _gf2_dot(_bits_of_bytes(chunks), _chunk_basis_matrix())  # (M, 32)
    level = 0
    while v.shape[0] > 1:
        lo = v[0::2]                                    # earlier chunks
        hi = v[1::2]
        v = _gf2_dot(lo, _level_matrix(level)) ^ hi
        level += 1
    vbits = v[0].astype(jnp.uint32)                     # (32,) 0/1
    return jnp.sum(vbits << jnp.arange(32, dtype=jnp.uint32))


def crc32_batch_jax(data: jnp.ndarray, lengths) -> jnp.ndarray:
    """Batched CRC-32 of right-aligned rows.

    Args:
        data: (B, N) uint8 with each row's payload occupying the LAST
            ``lengths[i]`` bytes (front zero-padding does not perturb the
            raw CRC register, so one fixed-shape kernel serves all rows).
        lengths: (B,) host ints — true byte counts.

    Returns (B,) uint32 CRCs (numpy, after host init-term fold).
    """
    import numpy as _np
    bsz, n = data.shape
    m = max(1, -(-n // CHUNK))
    mp = 1 << (m - 1).bit_length()
    padded = jnp.pad(data.astype(jnp.uint8), ((0, 0), (mp * CHUNK - n, 0)))
    f = jax.vmap(lambda row: _crc32_f_padded(row.reshape(mp, CHUNK)))(padded)
    f = _np.asarray(f, dtype=_np.uint32)
    lens = _np.asarray(lengths)
    init = _np.array([_init_term(int(l)) for l in lens], dtype=_np.uint32)
    out = (f ^ init) ^ _np.uint32(0xFFFFFFFF)
    out[lens == 0] = 0
    return out


def _apply_gf2_cols(values: jnp.ndarray, cols: np.ndarray) -> jnp.ndarray:
    """Apply a GF(2) operator (given as 32 column u32s) to (B,) uint32s."""
    bits = (values[:, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    out = _gf2_dot(bits, _cols_matrix(cols)).astype(jnp.uint32)
    return jnp.sum(out << jnp.arange(32, dtype=jnp.uint32)[None, :], axis=1)


def _cols_matrix(cols) -> np.ndarray:
    """(32, 32) 0/1 matrix of a GF(2) operator given as 32 column u32s:
    element [j, o] = bit o of column j."""
    c = np.asarray(cols, np.uint64)[:, None] >> np.arange(32, dtype=np.uint64)
    return (c & np.uint64(1)).astype(np.int8)


@functools.partial(jax.jit, static_argnames=())
def crc32_f_rows(data: jnp.ndarray) -> jnp.ndarray:
    """Raw CRC f-values of LEFT-aligned (B, N) uint8 rows.

    Works for any N: rows are zero-padded at the END to a power-of-two
    chunk count (the tree fold needs 2^k chunks), then the trailing-zero
    shift is folded back out on device with one constant GF(2) matmul,
    so the result is the register over exactly the N row bytes.  Rows
    are processed whole (including the caller's own trailing zero
    padding within N); fold that padding back out host-side with
    :func:`crc32_from_padded_f`.  Returns (B,) int32 bit patterns
    (bitcast of the uint32 register).
    """
    bsz, n = data.shape
    m = max(1, -(-n // CHUNK))
    mp = 1 << (m - 1).bit_length()                      # power-of-two chunks
    pad = mp * CHUNK - n
    if pad:
        data = jnp.pad(data, ((0, 0), (0, pad)))
    f = jax.vmap(lambda row: _crc32_f_padded(row.reshape(mp, CHUNK)))(data)
    if pad:
        # Trailing zeros multiplied the register by A_pad; undo on device.
        f = _apply_gf2_cols(f, _inv_shift_cols(pad))
    return jax.lax.bitcast_convert_type(f, jnp.int32)


@functools.lru_cache(maxsize=1024)
def _inv_shift_cols(pad: int) -> np.ndarray:
    """Columns of the inverse zero-byte shift operator A_pad^{-1}."""
    from ..utils.checksum import gf2_matrix_inverse
    return gf2_matrix_inverse(_shift_operator(pad))


def crc32_from_padded_f(f_rows: np.ndarray, lengths, row_bytes: int
                        ) -> np.ndarray:
    """Finish CRCs from :func:`crc32_f_rows` output.

    ``f_rows`` are raw registers over the full row INCLUDING trailing
    zeros; processing ``pad`` zero bytes multiplies the register by the
    shift operator A_pad, so the true-data register is A_pad^{-1}·f.
    """
    f = np.asarray(f_rows).view(np.uint32)
    lens = np.asarray(lengths)
    out = np.zeros(len(f), np.uint32)
    for i, (fv, ln) in enumerate(zip(f, lens)):
        ln = int(ln)
        if ln == 0:
            continue
        pad = row_bytes - ln
        v = int(fv)
        if pad:
            v = _gf2_matrix_times(_inv_shift_cols(pad), v)
        out[i] = (v ^ _init_term(ln)) ^ 0xFFFFFFFF
    return out


def crc32_jax(data: jnp.ndarray) -> jnp.ndarray:
    """CRC-32 of a uint8 array (device computation, host padding)."""
    n = int(data.shape[0])
    if n == 0:
        return jnp.uint32(0)
    n_chunks = max(1, -(-n // CHUNK))
    m = 1 << (n_chunks - 1).bit_length()                # next power of two
    pad = m * CHUNK - n
    padded = jnp.pad(data.astype(jnp.uint8), (pad, 0))  # front zero-pad
    return _crc32_padded(padded.reshape(m, CHUNK), n)


# ---------------------------------------------------------------------------
# CRC-32 shard combine (device version of utils.checksum.crc32_combine)
# ---------------------------------------------------------------------------
def crc32_combine_jax(crc1: jnp.ndarray, crc2: jnp.ndarray,
                      len2: int) -> jnp.ndarray:
    """Combine two device CRCs; ``len2`` static (shapes are static anyway)."""
    shifted = _apply_gf2_cols(crc1.astype(jnp.uint32)[None],
                              _shift_operator(len2))
    return shifted[0] ^ crc2.astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Adler-32 device kernel
# ---------------------------------------------------------------------------
_ADLER_CHUNK = 1024   # max safe: sum((C-t)*255) + slack < 2^31


def _modmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a*b) mod 65521 for 0 <= a,b < 65536 without int64."""
    m = ADLER32_MOD
    a1 = a >> 8
    a0 = a & 0xFF
    return (a1 * ((b << 8) % m) + a0 * b) % m


@functools.partial(jax.jit, static_argnames=("length",))
def _adler32_padded(chunks: jnp.ndarray, length: int) -> jnp.ndarray:
    """Adler-32 of ``length`` bytes end-zero-padded into (J, C) int32."""
    J, Cc = chunks.shape
    m = ADLER32_MOD
    sa = jnp.sum(chunks, axis=1) % m                        # (J,)
    weights = jnp.arange(Cc, 0, -1, dtype=jnp.int32)        # C - t
    sb = jnp.sum(chunks * weights[None, :], axis=1) % m     # (J,)
    # A = 1 + sum(bytes); B = n + sum_j [ sb_j + ((n - (j+1)C) mod m) * sa_j ]
    # zero padding at the end contributes nothing to sa/sb, and the
    # (n-(j+1)C) coefficient is computed for true n (may go negative for
    # the tail chunk; mod-normalize first).
    jidx = jnp.arange(J, dtype=jnp.int32)
    coef = ((length - (jidx + 1) * Cc) % m + m) % m
    a = (1 + jnp.sum(sa)) % m
    b = (length % m + (jnp.sum((sb + _modmul(coef, sa)) % m)) % m) % m
    return (b.astype(jnp.uint32) << 16) | a.astype(jnp.uint32)


def adler32_jax(data: jnp.ndarray) -> jnp.ndarray:
    """Adler-32 of a uint8 array."""
    n = int(data.shape[0])
    if n == 0:
        return jnp.uint32(1)
    j = -(-n // _ADLER_CHUNK)
    pad = j * _ADLER_CHUNK - n
    padded = jnp.pad(data.astype(jnp.int32), (0, pad))
    return _adler32_padded(padded.reshape(j, _ADLER_CHUNK), n)


def adler32_combine_jax(ad1: jnp.ndarray, ad2: jnp.ndarray,
                        len2: int) -> jnp.ndarray:
    """Device shard-combine for Adler-32."""
    m = ADLER32_MOD
    a1 = (ad1 & 0xFFFF).astype(jnp.int32)
    b1 = ((ad1 >> 16) & 0xFFFF).astype(jnp.int32)
    a2 = (ad2 & 0xFFFF).astype(jnp.int32)
    b2 = ((ad2 >> 16) & 0xFFFF).astype(jnp.int32)
    rem = jnp.int32(len2 % m)
    a = (a1 + a2 - 1) % m
    b = (b1 + b2 + _modmul(rem, (a1 - 1) % m)) % m
    a = (a + m) % m
    b = (b + m) % m
    return (b.astype(jnp.uint32) << 16) | a.astype(jnp.uint32)
