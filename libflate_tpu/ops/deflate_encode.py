"""Device (JAX) DEFLATE block encoder: tokens → packed bit stream.

The device encode pipeline for one block (vmap over blocks):

    token arrays (a, b)          [b == 0 ⇒ literal a; else length-a/dist-b]
      → symbol histograms        (scatter-add)
      → package-merge lengths    (ops.huffman, vectorized)
      → canonical + reversed codes
      → dynamic-header fields + token fields   (pure gathers)
      → pack_fields              (prefix-sum bit packer)

Design notes vs the reference encoder (src/deflate/encode.rs:386-426):
* The whole block is a flat ``(value, width)`` field stream — the
  3-bit block header, the HLIT/HDIST/HCLEN preamble, the code-length
  codes, every symbol, every extra-bit field — packed in one shot.
* HLIT/HDIST are pinned to their maxima (286/30 symbols always
  transmitted).  That keeps shapes static; the cost is a few dozen bytes
  of header per block, recovered by code-length RLE later.  The
  code-length alphabet currently emits literal lengths only (no 16/17/18
  repeats — valid per RFC-1951, slightly larger headers).
* Distance-less blocks get the dummy distance code
  (parity: src/deflate/symbol.rs:332-337).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import constants as C
from .bitpack import pack_fields
from .huffman import (canonical_codes_jax, package_merge_lengths,
                      reverse_codes_jax)

# LUTs as device constants
_LEN_CODE = jnp.asarray(C.LENGTH_TO_CODE)        # (259,)
_LEN_NEXTRA = jnp.asarray(C.LENGTH_TO_NEXTRA)
_LEN_EXTRA = jnp.asarray(C.LENGTH_TO_EXTRA)
_DIST_CODE = jnp.asarray(C.DIST_TO_CODE)         # (32769,)
_DIST_NEXTRA = jnp.asarray(C.DIST_TO_NEXTRA)
_DIST_EXTRA = jnp.asarray(C.DIST_TO_EXTRA)
_CLC_ORDER = jnp.asarray(C.CLC_ORDER)

N_LIT = C.MAX_LITLEN_SYMBOLS                     # 286
N_DIST = C.MAX_DIST_SYMBOLS                      # 30
N_CLC = C.MAX_CLC_SYMBOLS                        # 19
# header field count: BFINAL/BTYPE + HLIT + HDIST + HCLEN + 19 CLC widths
N_HEADER_FIELDS = 1 + 3 + N_CLC
N_LENGTH_FIELDS = N_LIT + N_DIST                 # 316 literal CLC codes


def token_symbols(a: jnp.ndarray, b: jnp.ndarray, valid: jnp.ndarray):
    """Map token arrays to (lit symbol, dist symbol-or--1)."""
    is_match = (b > 0) & valid
    lit_sym = jnp.where(is_match, _LEN_CODE[jnp.clip(a, 0, C.MAX_MATCH)],
                        jnp.clip(a, 0, 255))
    dist_sym = jnp.where(is_match,
                         _DIST_CODE[jnp.clip(b, 0, C.MAX_DISTANCE)], -1)
    return lit_sym, dist_sym, is_match


@jax.jit
def token_histograms_jax(a: jnp.ndarray, b: jnp.ndarray,
                         n_tokens: jnp.ndarray):
    """Masked per-block symbol histograms incl. EOB and dummy distance."""
    m = a.shape[0]
    valid = jnp.arange(m, dtype=jnp.int32) < n_tokens
    return token_histograms_masked(a, b, valid)


@jax.jit
def token_histograms_masked(a: jnp.ndarray, b: jnp.ndarray,
                            valid: jnp.ndarray):
    """Histograms over an explicit valid-slot mask."""
    lit_sym, dist_sym, is_match = token_symbols(a, b, valid)
    lit_freq = jnp.zeros((N_LIT,), jnp.int32).at[
        jnp.where(valid, lit_sym, N_LIT - 1)].add(
        valid.astype(jnp.int32), mode="drop")
    lit_freq = lit_freq.at[C.END_OF_BLOCK].add(1)
    dist_freq = jnp.zeros((N_DIST,), jnp.int32).at[
        jnp.where(is_match, dist_sym, 0)].add(
        is_match.astype(jnp.int32), mode="drop")
    # dummy distance code when the block has no pointers
    dist_freq = jnp.where(dist_freq.sum() == 0,
                          jnp.zeros((N_DIST,), jnp.int32).at[0].set(1),
                          dist_freq)
    return lit_freq, dist_freq


def _encoder_tables(lengths: jnp.ndarray):
    codes = canonical_codes_jax(lengths)
    return reverse_codes_jax(codes, lengths), lengths


def rle_code_lengths_jax(seq: jnp.ndarray):
    """Vectorized RFC-1951 §3.2.7 code-length RLE.

    Position-parallel formulation of the reference's run builder
    (src/deflate/symbol.rs:486-540): every input position emits at most
    one (clc_symbol, extra, n_extra) field; non-emitting positions get
    the sentinel symbol -1.  Runs are found with a diff+segmented-scan;
    the 16/17/18 chunking within a run is pure per-position arithmetic
    on (value, run length, offset-in-run).

    Returns (sym (N,), extra (N,), n_extra (N,)) with sym == -1 for holes.
    """
    n = seq.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    new_run = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                               seq[1:] != seq[:-1]])
    # start index of each position's run via running max of start marks
    # (lax.cummax is a primitive; associative_scan would build a sliced
    # log-depth graph that is slow to compile)
    start_idx = jax.lax.cummax(jnp.where(new_run, idx, 0))
    k = idx - start_idx                                   # offset in run
    # run length: scatter-count by start index, gathered back
    run_len = jnp.zeros((n,), jnp.int32).at[start_idx].add(1)[start_idx]
    v = seq

    # ---- zero runs: 18-chunks (11..138), then 17 (3..10), else literals
    m = run_len
    c18 = m // 138
    rem_a = m - c18 * 138
    # after the full-138 chunks: one more 18 if rem >= 11, else one 17 if
    # rem >= 3, else rem literal zeros
    extra18_chunk = rem_a >= 11
    use17 = (rem_a >= 3) & (rem_a < 11)
    chunk_of_k = k // 138
    j_in_chunk = k % 138
    in_full18 = chunk_of_k < c18
    in_extra18 = (chunk_of_k == c18) & extra18_chunk
    zero_sym = jnp.where(
        (j_in_chunk == 0) & in_full18, 18,
        jnp.where((j_in_chunk == 0) & in_extra18, 18,
                  jnp.where((chunk_of_k == c18) & use17 & (j_in_chunk == 0),
                            17,
                            jnp.where((chunk_of_k == c18) & ~extra18_chunk
                                      & ~use17, 0, -1))))
    zero_extra = jnp.where(
        (j_in_chunk == 0) & in_full18, 138 - 11,
        jnp.where((j_in_chunk == 0) & in_extra18, rem_a - 11,
                  jnp.where(use17, rem_a - 3, 0)))
    zero_nbits = jnp.where(zero_sym == 18, 7,
                           jnp.where(zero_sym == 17, 3, 0))

    # ---- nonzero runs: leading literal, then 16-chunks of 3..6, tail
    # literals when the remainder is < 3
    m2 = run_len - 1                       # repeats after the literal
    kk = k - 1                             # offset among the repeats
    c6 = m2 // 6
    rem_b = m2 - c6 * 6
    chunk6 = kk // 6
    j6 = kk % 6
    in_full6 = chunk6 < c6
    tail_is_16 = rem_b >= 3
    nz_sym = jnp.where(
        k == 0, v,
        jnp.where((j6 == 0) & in_full6, 16,
                  jnp.where((chunk6 == c6) & tail_is_16 & (j6 == 0), 16,
                            jnp.where((chunk6 == c6) & ~tail_is_16, v,
                                      -1))))
    nz_extra = jnp.where((j6 == 0) & in_full6, 6 - 3,
                         jnp.where((chunk6 == c6) & tail_is_16, rem_b - 3,
                                   0))
    nz_extra = jnp.where(nz_sym == 16, nz_extra, 0)
    nz_nbits = jnp.where(nz_sym == 16, 2, 0)

    is_zero = v == 0
    sym = jnp.where(is_zero, zero_sym, nz_sym)
    extra = jnp.where(is_zero, zero_extra, nz_extra)
    nbits = jnp.where(is_zero, zero_nbits, nz_nbits)
    return sym, extra, nbits


def token_fields_xla(a: jnp.ndarray, b: jnp.ndarray, valid: jnp.ndarray,
                     lit_rev: jnp.ndarray, lit_w: jnp.ndarray,
                     dist_rev: jnp.ndarray, dist_w: jnp.ndarray):
    """Token fields of one block from the encoder tables (gathers from
    small tables, fused by XLA).

    Returns (f1v, f1w, f2v, f2w) each (M,) int32.
    """
    is_match = (b > 0) & valid
    lit_sym = jnp.where(is_match, _LEN_CODE[jnp.clip(a, 0, C.MAX_MATCH)],
                        jnp.clip(a, 0, 255))
    a_len = jnp.clip(a, 0, C.MAX_MATCH)
    b_dist = jnp.clip(b, 0, C.MAX_DISTANCE)
    lw = lit_w[lit_sym]
    f1v = lit_rev[lit_sym] | jnp.where(is_match,
                                       _LEN_EXTRA[a_len] << lw, 0)
    f1v = jnp.where(valid, f1v, 0)
    f1w = jnp.where(valid, lw + jnp.where(is_match,
                                          _LEN_NEXTRA[a_len], 0), 0)
    ds = jnp.where(is_match, _DIST_CODE[b_dist], 0)
    dw = dist_w[ds]
    f2v = jnp.where(is_match,
                    dist_rev[ds] | (_DIST_EXTRA[b_dist] << dw), 0)
    f2w = jnp.where(is_match, dw + _DIST_NEXTRA[b_dist], 0)
    return f1v, f1w, f2v, f2w


def dynamic_header_fields(lit_lengths: jnp.ndarray,
                          dist_lengths: jnp.ndarray,
                          bfinal: jnp.ndarray):
    """Dynamic-block header as (value, width) fields.

    Returns (hdr_vals (23,), hdr_widths, len_vals (316,), len_widths):
    BFINAL/BTYPE + HLIT/HDIST/HCLEN + 19 CLC widths, then the RLE'd
    code-length codes (holes are width-0 fields).
    """
    lengths_seq = jnp.concatenate([lit_lengths, dist_lengths])  # (316,)
    rle_sym, rle_extra, rle_nbits = rle_code_lengths_jax(lengths_seq)
    emitted = rle_sym >= 0
    clc_freq = jnp.sum(
        ((rle_sym[:, None] == jnp.arange(N_CLC)[None, :]) &
         emitted[:, None]).astype(jnp.int32), axis=0)
    clc_lengths = package_merge_lengths(clc_freq, C.MAX_CLC_BITWIDTH)
    clc_rev, clc_w = _encoder_tables(clc_lengths)

    hdr_vals = jnp.concatenate([
        jnp.stack([bfinal.astype(jnp.int32) | (C.BTYPE_DYNAMIC << 1),
                   jnp.int32(N_LIT - 257),
                   jnp.int32(N_DIST - 1),
                   jnp.int32(N_CLC - 4)]),
        clc_lengths[_CLC_ORDER],
    ])
    hdr_widths = jnp.concatenate([
        jnp.asarray([3, 5, 5, 4], jnp.int32),
        jnp.full((N_CLC,), 3, jnp.int32),
    ])
    sym_c = jnp.clip(rle_sym, 0, N_CLC - 1)
    cw = clc_w[sym_c]
    len_vals = jnp.where(emitted, clc_rev[sym_c] | (rle_extra << cw), 0)
    len_widths = jnp.where(emitted, cw + rle_nbits, 0)
    return hdr_vals, hdr_widths, len_vals, len_widths


@functools.partial(jax.jit, static_argnames=("block_type",))
def encode_block_fields(a: jnp.ndarray, b: jnp.ndarray,
                        n_tokens: jnp.ndarray, bfinal: jnp.ndarray,
                        block_type: str = "dynamic"):
    """Produce the complete (values, widths) field stream for one block.

    Returns (values, widths): shape (N_HEADER_FIELDS + N_LENGTH_FIELDS +
    2*M + 1,) — header fields have width 0 for fixed blocks.

    ``block_type="auto"`` builds both dynamic and fixed streams (the
    expensive parts — histograms + package-merge — are shared) and
    selects whichever is smaller in total bits, per block.
    """
    if block_type == "auto":
        dv, dw = encode_block_fields(a, b, n_tokens, bfinal, "dynamic")
        fv, fw = encode_block_fields(a, b, n_tokens, bfinal, "fixed")
        use_dyn = jnp.sum(dw) <= jnp.sum(fw)
        return (jnp.where(use_dyn, dv, fv), jnp.where(use_dyn, dw, fw))
    m = a.shape[0]
    valid = jnp.arange(m, dtype=jnp.int32) < n_tokens
    lit_sym, dist_sym, is_match = token_symbols(a, b, valid)

    if block_type == "dynamic":
        lit_freq, dist_freq = token_histograms_jax(a, b, n_tokens)
        lit_lengths = package_merge_lengths(lit_freq, C.MAX_BITWIDTH)
        dist_lengths = package_merge_lengths(dist_freq, C.MAX_BITWIDTH)
        btype = C.BTYPE_DYNAMIC
    else:
        # full 288-symbol alphabet: symbols 286/287 shift the canonical
        # 9-bit code range (RFC-1951 §3.2.6) even though never emitted
        lit_lengths = jnp.asarray(C.fixed_litlen_lengths())
        dist_lengths = jnp.asarray(C.fixed_dist_lengths())
        btype = C.BTYPE_FIXED

    lit_rev, lit_w = _encoder_tables(lit_lengths)
    dist_rev, dist_w = _encoder_tables(dist_lengths)

    # ---- header fields -----------------------------------------------------
    if block_type == "dynamic":
        hdr_vals, hdr_widths, len_vals, len_widths = dynamic_header_fields(
            lit_lengths, dist_lengths, bfinal)
    else:
        pad_h = N_HEADER_FIELDS - 1
        hdr_vals = jnp.concatenate([
            jnp.stack([bfinal.astype(jnp.int32) | (btype << 1)]),
            jnp.zeros((pad_h,), jnp.int32)])
        hdr_widths = jnp.concatenate([
            jnp.asarray([3], jnp.int32), jnp.zeros((pad_h,), jnp.int32)])
        len_vals = jnp.zeros((N_LENGTH_FIELDS,), jnp.int32)
        len_widths = jnp.zeros((N_LENGTH_FIELDS,), jnp.int32)

    # ---- token fields ------------------------------------------------------
    a_len = jnp.clip(a, 0, C.MAX_MATCH)
    b_dist = jnp.clip(b, 0, C.MAX_DISTANCE)
    lw = lit_w[lit_sym]
    f1_val = lit_rev[lit_sym] | jnp.where(
        is_match, _LEN_EXTRA[a_len] << lw, 0)
    f1_width = jnp.where(valid, lw + jnp.where(is_match,
                                               _LEN_NEXTRA[a_len], 0), 0)
    ds = jnp.where(is_match, dist_sym, 0)
    dw = dist_w[ds]
    f2_val = jnp.where(is_match,
                       dist_rev[ds] | (_DIST_EXTRA[b_dist] << dw), 0)
    f2_width = jnp.where(is_match, dw + _DIST_NEXTRA[b_dist], 0)

    # interleave f1/f2 per token
    tok_vals = jnp.stack([f1_val, f2_val], axis=1).reshape(-1)
    tok_widths = jnp.stack([f1_width, f2_width], axis=1).reshape(-1)

    eob_val = lit_rev[C.END_OF_BLOCK][None]
    eob_width = lit_w[C.END_OF_BLOCK][None]

    values = jnp.concatenate([hdr_vals, len_vals, tok_vals, eob_val])
    widths = jnp.concatenate([hdr_widths, len_widths, tok_widths, eob_width])
    return values, widths


def encode_block(a: jnp.ndarray, b: jnp.ndarray, n_tokens: jnp.ndarray,
                 bfinal: jnp.ndarray, block_type: str = "dynamic"):
    """Encode one block: returns (words (W,) uint32, total_bits)."""
    values, widths = encode_block_fields(a, b, n_tokens, bfinal, block_type)
    return pack_fields(values, widths)


def encode_blocks(a: jnp.ndarray, b: jnp.ndarray, n_tokens: jnp.ndarray,
                  bfinal: jnp.ndarray, block_type: str = "dynamic"):
    """Batched block encode: (B, M) token arrays → (B, W) words, (B,) bits."""
    return jax.vmap(
        lambda aa, bb, nn, ff: encode_block(aa, bb, nn, ff, block_type)
    )(a, b, n_tokens, bfinal)


# ---------------------------------------------------------------------------
# Host-side splice: shift each block's words to its global bit offset
# ---------------------------------------------------------------------------
def splice_blocks_host(words: np.ndarray, bits: np.ndarray) -> bytes:
    """Concatenate per-block bit streams (numpy host path).

    words: (B, W) uint32, bits: (B,) int — meaningful bit counts.
    Returns the packed byte string (final byte zero-padded).
    """
    total_bits = int(np.sum(bits))
    out = np.zeros((total_bits + 63) // 32 + 2, dtype=np.uint64)
    offset = 0
    for blk in range(words.shape[0]):
        nb = int(bits[blk])
        if nb == 0:
            continue
        nw = (nb + 31) // 32
        w = words[blk, :nw].astype(np.uint64)
        # mask tail bits beyond nb
        tail = nb & 31
        if tail:
            w[-1] &= (np.uint64(1) << np.uint64(tail)) - np.uint64(1)
        word0 = offset >> 5
        sh = np.uint64(offset & 31)
        lo = (w << sh) & np.uint64(0xFFFFFFFF)
        hi = w >> (np.uint64(32) - sh) if sh else np.zeros_like(w)
        out[word0:word0 + nw] |= lo
        out[word0 + 1:word0 + 1 + nw] |= hi
        offset += nb
    out32 = out.astype(np.uint32)
    raw = out32.view(np.uint8)[: (total_bits + 7) // 8]
    return raw.tobytes()
