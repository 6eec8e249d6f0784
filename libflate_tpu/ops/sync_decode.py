"""Sync-point symbol decode for indexed shared-table PGZF streams.

The PGZF encoder records the bit offset of every K-th token of a member
in a gzip EXTRA subfield (id ``b"LS"``, ignored by stock tools).  Each
K-token chunk then decodes independently with no speculation: one lane
per chunk, each lane a chain of K dependent table lookups.

Two implementations share one per-token step (``_decode_token``):

* ``sync_decode`` — a Pallas kernel compiled through Triton on the GPU:
  ``BLOCK`` chunks per program, the 64-bit bit window in registers, the
  shared litlen / distance roots read through the cache hierarchy.  On
  the CPU backend it runs in the Pallas interpreter (ops/device).
* ``sync_decode_xla`` — the same step as a ``lax.scan`` over tokens;
  the plain reference the kernel is tested against.

Layout: the compressed stream itself is the input — ``words`` is the
stream as little-endian uint32 words (3 words of zero slack at the
end), and chunk ``s`` starts at bit ``chunk_bit[s]`` of word
``chunk_word[s]``.  No per-chunk staging copy is made.  Output token
``i`` of chunk ``s`` lands at ``tokens[i, s]``, so each step of a
program stores one contiguous row segment.  Tokens are packed
``a | (b << 9)`` (a: literal byte or match length; b: distance, 0 for
literals), the native engine's packing.

Parity: replaces the reference's sequential symbol loop
(src/deflate/decode.rs:112-130 + huffman.rs:157-179) with an
index-parallel decomposition; the oracles are the serial and native
engines.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..spec import constants as C
from . import device
from .huffman import decode_table

SYNC_TOKENS = 256        # K: tokens per sync chunk (encoder side)
ROOT_BITS = 12           # widest litlen root the sync path accepts
DIST_ROOT_BITS = 8       # distance root (30 symbols, code lengths <= 8)
BLOCK = 128              # chunks (lanes) per kernel program
SLACK_WORDS = 3          # zero words past the stream end (window reads)


def stream_words(data: bytes) -> np.ndarray:
    """Bytes -> little-endian uint32 words plus SLACK_WORDS zero words."""
    pad = (-len(data)) % 4 + 4 * SLACK_WORDS
    return np.frombuffer(bytes(data) + b"\x00" * pad, "<u4")


def _length_code(li):
    """(base, extra bits) of length code 257 + li, li in [0, 28]."""
    nx = jnp.where((li < 8) | (li == 28), 0, (li - 4) >> 2)
    base = jnp.where(li < 8, li + 3,
                     jnp.where(li == 28, 258, ((4 + (li & 3)) << nx) + 3))
    return base, nx


def _dist_code(d):
    """(base, extra bits) of distance code d in [0, 29]."""
    nx = jnp.maximum(d - 2, 0) >> 1
    base = jnp.where(d < 2, d + 1, ((2 + (d & 1)) << nx) + 1)
    return base, nx


def _bits(lo, hi, k, nbits):
    """Bits [k, k + nbits) of the 64-bit window (lo, hi); k < 64.

    Every shift amount stays in [0, 31]: a 32-bit shift by 32 is
    undefined in Triton."""
    k = k.astype(jnp.uint32)
    use_hi = k >= 32
    ks = k & jnp.uint32(31)
    a = jnp.where(use_hi, hi, lo)
    b = jnp.where(use_hi, jnp.uint32(0), hi)
    v = (a >> ks) | ((b << (jnp.uint32(31) - ks)) << jnp.uint32(1))
    mask = (jnp.uint32(1) << jnp.asarray(nbits).astype(jnp.uint32)) - 1
    return (v & mask).astype(jnp.int32)


def _decode_token(w0, w1, w2, r, lit_lookup, dist_lookup, root_bits):
    """One token from the 96 stream bits w0..w2 starting at bit r < 32.

    Returns (packed token, bits consumed); a litlen or distance code
    with no table entry consumes 0 bits."""
    r = r.astype(jnp.uint32)
    inv = jnp.uint32(31) - r
    lo = (w0 >> r) | ((w1 << inv) << jnp.uint32(1))
    hi = (w1 >> r) | ((w2 << inv) << jnp.uint32(1))

    e = lit_lookup((lo & jnp.uint32((1 << root_bits) - 1))
                   .astype(jnp.int32))
    width = e & 15
    sym = e >> 4
    is_len = sym > C.END_OF_BLOCK
    lbase, lnx = _length_code(jnp.clip(sym - 257, 0, 28))
    length = lbase + _bits(lo, hi, width, lnx)
    k2 = width + jnp.where(is_len, lnx, 0)
    de = dist_lookup(_bits(lo, hi, k2, DIST_ROOT_BITS))
    dw = de & 15
    dbase, dnx = _dist_code(jnp.clip(de >> 4, 0, 29))
    k3 = k2 + dw
    dist = dbase + _bits(lo, hi, k3, dnx)
    total = jnp.where(is_len, jnp.where(dw > 0, k3 + dnx, 0), width)
    a = jnp.where(is_len, length, sym)
    b = jnp.where(is_len, dist, 0)
    return jnp.clip(a, 0, 511) | (jnp.clip(b, 0, 65535) << 9), total


def _sync_kernel(words_ref, cw_ref, cb_ref, cnt_ref, tab_ref, lit_ref,
                 dist_ref, tok_ref, end_ref, *, k_tokens: int,
                 root_bits: int, n_words: int):
    base = cw_ref[...]
    cnt = cnt_ref[...]
    tab = tab_ref[...]
    lit_off = tab << root_bits
    dist_off = tab << DIST_ROOT_BITS

    def step(i, cursor):
        w = jnp.minimum(base + (cursor >> 5), n_words - SLACK_WORDS)
        tok, total = _decode_token(
            words_ref[w], words_ref[w + 1], words_ref[w + 2], cursor & 31,
            lambda j: lit_ref[lit_off + j],
            lambda j: dist_ref[dist_off + j], root_bits)
        active = i < cnt
        tok_ref[i, :] = jnp.where(active, tok, 0)
        return jnp.where(active, cursor + total, cursor)

    end_ref[...] = jax.lax.fori_loop(0, k_tokens, step, cb_ref[...])


@functools.partial(jax.jit, static_argnames=("k_tokens", "root_bits"))
def sync_decode(words, chunk_word, chunk_bit, counts, table, lit_tables,
                dist_tables, k_tokens: int = SYNC_TOKENS,
                root_bits: int = ROOT_BITS):
    """Decode S independent chunks of at most ``k_tokens`` tokens.

    Args:
        words: (W,) uint32 stream words (stream_words layout).
        chunk_word: (S,) int32 word index of each chunk's first bit.
        chunk_bit: (S,) int32 start bit within that word, in [0, 32).
        counts: (S,) int32 tokens to decode per chunk (<= k_tokens).
        table: (S,) int32 index of the chunk's code tables.
        lit_tables: (G * 2**root_bits,) int32 flat litlen roots
            (ops.huffman.decode_table entries ``sym << 4 | width``).
        dist_tables: (G * 256,) int32 flat 8-bit distance roots.

    Returns:
        (tokens (k_tokens, S) int32, end (S,) int32): token i of chunk s
        at ``tokens[i, s]`` (zero past the chunk's count), and the bit
        cursor after the chunk's last token, relative to bit 0 of
        ``chunk_word[s]``.  S must be a multiple of BLOCK.
    """
    s_n = chunk_word.shape[0]
    if s_n % BLOCK:
        raise ValueError(f"chunk count {s_n} is not a multiple of {BLOCK}")
    kern = functools.partial(_sync_kernel, k_tokens=k_tokens,
                             root_bits=root_bits, n_words=words.shape[0])
    whole = pl.BlockSpec(memory_space=pl.ANY)
    lane = pl.BlockSpec((BLOCK,), lambda p: (p,))
    return pl.pallas_call(
        kern,
        grid=(s_n // BLOCK,),
        in_specs=[whole, lane, lane, lane, lane, whole, whole],
        out_specs=[pl.BlockSpec((k_tokens, BLOCK), lambda p: (0, p)), lane],
        out_shape=[jax.ShapeDtypeStruct((k_tokens, s_n), jnp.int32),
                   jax.ShapeDtypeStruct((s_n,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=device.interpret(),
        name="sync_decode",
    )(words.astype(jnp.uint32), chunk_word.astype(jnp.int32),
      chunk_bit.astype(jnp.int32), counts.astype(jnp.int32),
      table.astype(jnp.int32), lit_tables.astype(jnp.int32),
      dist_tables.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("k_tokens", "root_bits"))
def sync_decode_xla(words, chunk_word, chunk_bit, counts, table,
                    lit_tables, dist_tables, k_tokens: int = SYNC_TOKENS,
                    root_bits: int = ROOT_BITS):
    """``sync_decode`` as a plain ``lax.scan`` over tokens (the
    reference); same arguments and results, any S."""
    n_words = words.shape[0]
    words = words.astype(jnp.uint32)
    base = chunk_word.astype(jnp.int32)
    lit_off = table.astype(jnp.int32) << root_bits
    dist_off = table.astype(jnp.int32) << DIST_ROOT_BITS

    def step(cursor, i):
        w = jnp.minimum(base + (cursor >> 5), n_words - SLACK_WORDS)
        tok, total = _decode_token(
            words[w], words[w + 1], words[w + 2], cursor & 31,
            lambda j: lit_tables[lit_off + j],
            lambda j: dist_tables[dist_off + j], root_bits)
        active = i < counts
        return (jnp.where(active, cursor + total, cursor),
                jnp.where(active, tok, 0))

    end, toks = jax.lax.scan(step, chunk_bit.astype(jnp.int32),
                             jnp.arange(k_tokens, dtype=jnp.int32))
    return toks, end


def decode_tables(lit_lengths: np.ndarray, dist_lengths: np.ndarray,
                  root_bits: int):
    """(G, 286) / (G, 30) shared code lengths -> flat device roots
    (G * 2**root_bits,) and (G * 256,) for sync_decode."""
    lit = jax.vmap(lambda ll: decode_table(ll, root_bits))(
        jnp.asarray(lit_lengths, jnp.int32))
    dist = jax.vmap(lambda dl: decode_table(dl, DIST_ROOT_BITS))(
        jnp.asarray(dist_lengths, jnp.int32))
    return lit.reshape(-1), dist.reshape(-1)
