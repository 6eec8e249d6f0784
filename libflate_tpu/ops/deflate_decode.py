"""Device (JAX) DEFLATE decoder: batched symbol scan + parallel expansion.

Data-parallel decomposition of the reference's decode hot loop
(reference: src/deflate/decode.rs:112-130 + huffman.rs:157-179):

* **Symbol scan** — the bit cursor is inherently serial *within* a
  stream, so throughput comes from decoding MANY independent streams in
  lockstep: one `lax.scan` step decodes one symbol per stream across the
  whole batch (flat-table peek→lookup→consume, branchless selects for
  literal/length/distance/EOB).
* **LZ77 expansion** — ops.device_expand.expand_tokens (pointer
  jumping over mod-collapsed source pointers).

Tables are built on-device by ops.huffman.decode_table from code lengths
(header parsing is a host/native concern — headers are ~100 bytes).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import constants as C
from .device_expand import expand_tokens
from .huffman import decode_table

_LEN_BASE = jnp.asarray(C.LENGTH_BASE)
_LEN_EXTRA = jnp.asarray(C.LENGTH_EXTRA)
_DIST_BASE = jnp.asarray(C.DIST_BASE)
_DIST_EXTRA = jnp.asarray(C.DIST_EXTRA)


def _peek(words: jnp.ndarray, pos: jnp.ndarray, nbits: int = 15
          ) -> jnp.ndarray:
    """Read ``nbits`` LSB-first bits at absolute bit offset ``pos``."""
    w = pos >> 5
    sh = (pos & 31).astype(jnp.uint32)
    lo = words[w] >> sh
    hi = (words[w + 1] << (jnp.uint32(31) - sh)) << jnp.uint32(1)
    return ((lo | hi) & ((1 << nbits) - 1)).astype(jnp.int32)


def _symbol_step(words, pos, lit_table, dist_table):
    """Decode one symbol per stream (vmapped): shared scan body."""

    def per_stream(wrds, p, lt, dt):
        e = lt[_peek(wrds, p)]
        width = e & 15
        sym = e >> 4
        bad = width == 0
        p1 = p + width
        is_len = sym > 256
        li = jnp.clip(sym - 257, 0, 28)
        nb = _LEN_EXTRA[li]
        extra = _peek(wrds, p1) & ((1 << nb) - 1)
        length = _LEN_BASE[li] + extra
        p2 = p1 + jnp.where(is_len, nb, 0)
        de = dt[_peek(wrds, p2)]
        dwidth = de & 15
        dsym = jnp.clip(de >> 4, 0, 29)
        dbad = is_len & (dwidth == 0)
        p3 = p2 + jnp.where(is_len, dwidth, 0)
        dnb = _DIST_EXTRA[dsym]
        dextra = _peek(wrds, p3) & ((1 << dnb) - 1)
        dist = _DIST_BASE[dsym] + dextra
        p4 = p3 + jnp.where(is_len, dnb, 0)
        a = jnp.where(is_len, length, sym)
        b = jnp.where(is_len, dist, 0)
        return a, b, p4, sym == 256, bad | dbad

    return jax.vmap(per_stream)(words, pos, lit_table, dist_table)


@functools.partial(jax.jit, static_argnames=("max_tokens", "chunk"))
def decode_symbols_chunked(words: jnp.ndarray, start_bit: jnp.ndarray,
                           lit_table: jnp.ndarray, dist_table: jnp.ndarray,
                           max_tokens: int, chunk: int = 4096):
    """decode_symbols with early exit: chunks of ``chunk`` scan steps run
    under a while_loop that stops once every stream hit its EOB.  Wall
    time tracks the *actual* longest token stream instead of the static
    worst case — matters when out_cap ≫ typical member token count."""
    bsz = words.shape[0]
    n_chunks = -(-max_tokens // chunk)
    t_pad = n_chunks * chunk

    def inner_step(carry, _):
        pos, done, err = carry
        a, b, new_pos, is_eob, bad = _symbol_step(words, pos, lit_table,
                                                  dist_table)
        active = ~(done | err)
        emit_valid = active & ~is_eob & ~bad
        pos = jnp.where(active, new_pos, pos)
        err = err | (active & bad)
        done = done | (active & is_eob)
        return (pos, done, err), (jnp.where(emit_valid, a, 0),
                                  jnp.where(emit_valid, b, 0), emit_valid)

    def cond(state):
        (_, done, err), _aa, _bb, _vv, ci = state
        return (ci < n_chunks) & jnp.any(~(done | err))

    def body(state):
        carry, aa, bb, vv, ci = state
        carry, (ca, cb, cv) = jax.lax.scan(inner_step, carry, None,
                                           length=chunk)
        col = ci * chunk
        aa = jax.lax.dynamic_update_slice(aa, jnp.transpose(ca), (0, col))
        bb = jax.lax.dynamic_update_slice(bb, jnp.transpose(cb), (0, col))
        vv = jax.lax.dynamic_update_slice(vv, jnp.transpose(cv), (0, col))
        return carry, aa, bb, vv, ci + 1

    init_carry = (start_bit.astype(jnp.int32),
                  jnp.zeros((bsz,), jnp.bool_),
                  jnp.zeros((bsz,), jnp.bool_))
    a0 = jnp.zeros((bsz, t_pad), jnp.int32)
    v0 = jnp.zeros((bsz, t_pad), jnp.bool_)
    (pos, done, err), a, b, vv, _ = jax.lax.while_loop(
        cond, body, (init_carry, a0, a0, v0, jnp.int32(0)))
    n_tokens = jnp.sum(vv.astype(jnp.int32), axis=1)
    err = err | ~done
    return (a[:, :max_tokens], b[:, :max_tokens], n_tokens, pos, err)


@functools.partial(jax.jit, static_argnames=("max_tokens",))
def decode_symbols(words: jnp.ndarray, start_bit: jnp.ndarray,
                   lit_table: jnp.ndarray, dist_table: jnp.ndarray,
                   max_tokens: int):
    """Batched symbol decode.

    Args:
        words: (B, W) uint32 — compressed bits per stream (2+ words of
            zero padding required past each stream's end).
        start_bit: (B,) int32 — bit offset of the first symbol.
        lit_table: (B, 2^15) int32 decode table (sym<<4|width).
        dist_table: (B, 2^15) int32.
        max_tokens: static scan length.

    Returns:
        (a, b, n_tokens, end_bit, err): token arrays (B, max_tokens),
        counts, bit offset just past EOB, error flags.
    """
    bsz = words.shape[0]

    def step(carry, _):
        pos, done, err = carry

        def per_stream(wrds, p, lt, dt):
            e = lt[_peek(wrds, p)]
            width = e & 15
            sym = e >> 4
            bad = width == 0
            p1 = p + width
            is_len = sym > 256
            li = jnp.clip(sym - 257, 0, 28)
            nb = _LEN_EXTRA[li]
            extra = _peek(wrds, p1) & ((1 << nb) - 1)
            length = _LEN_BASE[li] + extra
            p2 = p1 + jnp.where(is_len, nb, 0)
            de = dt[_peek(wrds, p2)]
            dwidth = de & 15
            dsym = jnp.clip(de >> 4, 0, 29)
            dbad = is_len & (dwidth == 0)
            p3 = p2 + jnp.where(is_len, dwidth, 0)
            dnb = _DIST_EXTRA[dsym]
            dextra = _peek(wrds, p3) & ((1 << dnb) - 1)
            dist = _DIST_BASE[dsym] + dextra
            p4 = p3 + jnp.where(is_len, dnb, 0)
            a = jnp.where(is_len, length, sym)
            b = jnp.where(is_len, dist, 0)
            return a, b, p4, sym == 256, bad | dbad

        a, b, new_pos, is_eob, bad = jax.vmap(per_stream)(
            words, pos, lit_table, dist_table)
        active = ~(done | err)
        emit_valid = active & ~is_eob & ~bad
        pos = jnp.where(active, new_pos, pos)
        err = err | (active & bad)
        done = done | (active & is_eob)
        return (pos, done, err), (jnp.where(emit_valid, a, 0),
                                  jnp.where(emit_valid, b, 0),
                                  emit_valid)

    init = (start_bit.astype(jnp.int32),
            jnp.zeros((bsz,), jnp.bool_), jnp.zeros((bsz,), jnp.bool_))
    (end_pos, done, err), (aa, bb, vv) = jax.lax.scan(
        step, init, None, length=max_tokens)
    a = jnp.transpose(aa)                      # (B, T)
    b = jnp.transpose(bb)
    n_tokens = jnp.sum(vv.astype(jnp.int32), axis=0)
    err = err | ~done                          # ran out of steps: error
    return a, b, n_tokens, end_pos, err


# ---------------------------------------------------------------------------
# Table construction from code lengths (device)
# ---------------------------------------------------------------------------
def tables_from_lengths(lit_lengths: jnp.ndarray,
                        dist_lengths: jnp.ndarray):
    """Batched (B, 286)/(B, 30) lengths → (B, 2^15) decode tables.

    Streams with an empty distance alphabet get an all-invalid distance
    table — any pointer then raises the error flag (parity:
    src/deflate/decode.rs pointer-with-no-distance-table error).
    """
    lit = jax.vmap(lambda l: decode_table(l, C.MAX_BITWIDTH))(lit_lengths)
    dist = jax.vmap(lambda l: decode_table(l, C.MAX_BITWIDTH))(dist_lengths)
    return lit, dist


# ---------------------------------------------------------------------------
# Host-orchestrated full inflate (foreign or own streams)
# ---------------------------------------------------------------------------
def _bytes_to_words(data: bytes, bucket: bool = False) -> np.ndarray:
    """Pack bytes into LSB-first uint32 words (+2 words of zero slack).

    ``bucket`` rounds the word count up to a power of two so repeated
    host-orchestrated calls with nearby stream sizes share one compiled
    shape (XLA recompiles per distinct shape)."""
    pad = (-len(data)) % 4 + 8
    arr = np.frombuffer(bytes(data) + b"\x00" * pad, np.uint8)
    words = arr.view("<u4")
    if bucket:
        n = max(64, 1 << (len(words) - 1).bit_length())
        if n > len(words):
            words = np.concatenate([words, np.zeros(n - len(words), "<u4")])
    return words


def inflate_device(data: bytes, out_cap: int | None = None):
    """Decode a complete raw DEFLATE stream, device compute per block.

    Host parses block headers (byte-scale work); the device decodes
    symbols and expands matches.  Blocks are processed sequentially
    (block k+1's position depends on block k's EOB) — the batched fast
    path for independent members lives in inflate_members_device.
    """
    from ..serial.bitio import BitReader
    from ..serial.deflate import DeflateError, InflateResult, \
        read_dynamic_header_lengths

    words_np = _bytes_to_words(data, bucket=True)
    words = jnp.asarray(words_np)
    out = bytearray()
    r = BitReader(bytes(data))
    while True:
        final = r.read_bits(1)
        btype = r.read_bits(2)
        if btype == C.BTYPE_STORED:
            r.align_byte()
            ln = r.read_bits(16)
            nlen = r.read_bits(16)
            if ln != (nlen ^ 0xFFFF):
                raise DeflateError("stored block LEN/NLEN mismatch")
            out += r.read_bytes(ln)
        else:
            if btype == C.BTYPE_FIXED:
                lit_l = np.asarray(C.fixed_litlen_lengths(), np.int32)
                dist_l = np.asarray(C.fixed_dist_lengths(), np.int32)
            elif btype == C.BTYPE_DYNAMIC:
                lit_l, dist_l = read_dynamic_header_lengths(r)
            else:
                raise DeflateError("reserved block type 0b11")
            start = r.bit_position
            lit_t, dist_t = tables_from_lengths(
                jnp.asarray(lit_l)[None, :], jnp.asarray(dist_l)[None, :])
            cap0 = out_cap or max(1 << 16, 4 * len(data) + 1024)
            cap0 = 1 << (cap0 - 1).bit_length()      # shape bucketing
            hist_cap = C.WINDOW_SIZE
            hist = np.zeros((1, hist_cap), np.uint8)
            tail = bytes(out[-hist_cap:])
            if tail:
                hist[0, hist_cap - len(tail):] = np.frombuffer(tail,
                                                               np.uint8)
            for attempt in range(4):
                cap = cap0 << (2 * attempt)
                # every token yields ≥1 output byte, and a symbol is ≥1
                # bit, so both bounds cap the scan length
                max_tokens = min(cap, 8 * len(data) + 64) + 1
                a, b, nt, end_bit, err = decode_symbols_chunked(
                    words[None, :], jnp.asarray([start], jnp.int32),
                    lit_t, dist_t, max_tokens)
                if bool(err[0]):
                    # token budget exhausted (every emitted slot valid)
                    # means the block outgrew cap — retry bigger; a bad
                    # code mid-stream leaves slack in the budget
                    if int(nt[0]) >= max_tokens - 1 and cap < 8 * len(data):
                        continue
                    raise DeflateError("invalid Huffman code in stream")
                chunk, n_out, xerr = expand_tokens(
                    a, b, nt, cap, jnp.asarray(hist),
                    jnp.asarray([len(tail)], jnp.int32))
                if not bool(xerr[0]):
                    break
                # distinguish overflow (token sizes sum past cap) from a
                # genuine bad back-reference before retrying bigger
                sizes = np.asarray(jnp.where(b > 0, a, 1))[0]
                if int(sizes[: int(nt[0])].sum()) <= cap:
                    raise DeflateError(
                        "back-pointer distance exceeds decoded history")
            else:
                raise DeflateError("output overflow")
            piece = np.asarray(chunk[0])[: int(n_out[0])]
            out += piece.tobytes()
            r = BitReader(bytes(data))
            r_state_bits = int(end_bit[0])
            r.byte_pos = r_state_bits // 8
            drop = r_state_bits % 8
            if drop:
                r.read_bits(drop)
        if final:
            return InflateResult(out, r.bit_position)
