"""End-to-end device DEFLATE pipelines + the "tpu" backend engine.

Encode: bytes → fixed-size independent blocks (data-parallel axis) →
tokenize (ops.sort_match candidates, ops.lz77 parse) → entropy encode
(ops.deflate_encode) → bit pack (ops.bitpack) → host bit-splice.  Every
stage is plain XLA.  Every block is a self-contained DEFLATE block (the
reference's per-flush LZ77 reset — libflate_lz77/src/default.rs:69-109 —
proves per-block independence; SURVEY.md §2.3.1), so blocks scale across
lanes, cores and chips without cross-talk.

The number of blocks is padded to the next power of two to bound XLA
recompilations across input sizes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..spec import constants as C
from .deflate_encode import encode_block, splice_blocks_host
from .lz77 import match_lengths, parse_tokens
from .sort_match import M_EXACT, sort_candidates

#: device-side block size: large enough to amortize per-block tables,
#: small enough to expose parallelism (and bound sort sizes)
DEVICE_BLOCK_SIZE = 64 * 1024


def _lengths_stage(blocks: jnp.ndarray, n_valid: jnp.ndarray,
                   cand: jnp.ndarray, m: jnp.ndarray, lazy: bool,
                   window: int, chain: int, lcp_rounds: int | None):
    """Candidate masking + match lengths (+ TOO_FAR / lazy heuristics).

    ``m`` is the sort matcher's exact shared length (up to M_EXACT
    bytes); matches that reach M_EXACT extend with the XLA LCP
    (ops.lz77.match_lengths), to at most 4*``lcp_rounds`` bytes when
    that is set (None: to MAX_MATCH).  ``chain > 1`` also scores the
    candidates of candidates (hash-chain depth, best-of on true LCPs,
    ties to the nearer candidate).

    ``lazy=True`` applies two elementwise ratio heuristics before the
    parse (both produce valid DEFLATE token choices): the zlib TOO_FAR
    rule (len-3 matches beyond 4 KiB cost more than 3 literals under
    typical codes) and one-step lazy matching — defer to position p+1
    when its match is strictly longer (reference analog: zlib
    deflate_slow).
    """
    n = blocks.shape[1]
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    cand = jnp.where(idx < n_valid[:, None], cand, -1)

    def lcp(c):
        return jax.vmap(lambda d, cc: match_lengths(
            d, cc, max_rounds=lcp_rounds))(blocks, c)

    if lcp_rounds is not None and 4 * lcp_rounds <= M_EXACT:
        lengths = jnp.where(cand >= 0, jnp.minimum(m, 4 * lcp_rounds), 0)
    else:
        lengths = jax.vmap(lambda d, cc, mm: match_lengths(
            d, cc, max_rounds=lcp_rounds, known=mm, known_cap=M_EXACT))(
            blocks, cand, m)
    deeper = cand
    for _ in range(chain - 1):
        # cand IS the chain: cand[q] is the previous position sharing
        # q's best prefix, so composing it walks one link further
        nxt = jnp.take_along_axis(cand, jnp.clip(deeper, 0, n - 1), axis=1)
        deeper = jnp.where((deeper >= 0) & (nxt >= 0)
                           & (idx - nxt <= window), nxt, -1)
        ld = lcp(deeper)
        upd = ld > lengths
        cand = jnp.where(upd, deeper, cand)
        lengths = jnp.where(upd, ld, lengths)
    # dist-1 (RLE) matches — the common source of long matches — are
    # exact by arithmetic: LCP(i, i-1) = run end - i, where a run end
    # is the first j >= i with data[j] != data[j+1]
    neq = jnp.concatenate(
        [blocks[:, 1:] != blocks[:, :-1],
         jnp.ones((blocks.shape[0], 1), jnp.bool_)], axis=1)
    first_neq = jax.lax.associative_scan(
        jnp.minimum, jnp.where(neq, idx, n), reverse=True, axis=1)
    rle_len = jnp.clip(first_neq + 1 - idx, 0, C.MAX_MATCH)
    is_rle = (cand == idx - 1) & jnp.concatenate(
        [jnp.zeros((blocks.shape[0], 1), jnp.bool_),
         ~neq[:, :-1]], axis=1)
    lengths = jnp.where(is_rle, jnp.maximum(lengths, rle_len), lengths)
    lengths = jnp.minimum(lengths, jnp.maximum(n_valid[:, None] - idx, 0))
    lengths = jnp.where(lengths >= C.MIN_MATCH, lengths, 0)
    if lazy:
        lengths = jnp.where((lengths == 3) & (idx - cand > 4096),
                            0, lengths)
        nxt = jnp.concatenate(
            [lengths[:, 1:], jnp.zeros((lengths.shape[0], 1),
                                       lengths.dtype)], axis=1)
        lengths = jnp.where((nxt > lengths) & (lengths > 0), 0, lengths)
    return cand, lengths


@functools.partial(jax.jit, static_argnames=("lazy", "window", "chain",
                                             "lcp_rounds"))
def _tokenize(blocks: jnp.ndarray, n_valid: jnp.ndarray,
              lazy: bool = True, window: int = C.MAX_DISTANCE,
              chain: int = 1, lcp_rounds: int | None = None):
    """(B, n) member bytes -> compacted tokens (a, b (B, n), counts (B,)).

    Sort matcher (ops/sort_match) -> match lengths -> greedy parse
    (ops.lz77.parse_tokens)."""
    with jax.named_scope("lf_match"):
        cand, m = sort_candidates(blocks, window=window)
    with jax.named_scope("lf_lengths"):
        cand, lengths = _lengths_stage(blocks, n_valid, cand, m, lazy,
                                       window, chain, lcp_rounds)
    parse = functools.partial(parse_tokens, max_tokens=blocks.shape[1])
    with jax.named_scope("lf_parse"):
        return jax.vmap(parse)(blocks, n_valid, cand, lengths)


def _device_knobs(options) -> dict:
    """EncodeOptions -> _tokenize keyword arguments (lazy, window,
    chain, lcp_rounds); only knobs changed from their defaults."""
    if options is None:
        return {}
    knobs = {}
    if getattr(options, "window_size", C.MAX_DISTANCE) != C.MAX_DISTANCE:
        knobs["window"] = int(options.window_size)
    if getattr(options, "lazy", True) is False:
        knobs["lazy"] = False
    if getattr(options, "matcher", "greedy") == "chain":
        knobs["chain"] = max(1, int(getattr(options, "max_chain", 1)))
    if getattr(options, "lcp_rounds", None) is not None:
        knobs["lcp_rounds"] = int(options.lcp_rounds)
    return knobs


@functools.partial(jax.jit, static_argnames=("block_type",))
def _fields_batch(a, b, cnt, bfinal, block_type: str):
    from .deflate_encode import encode_block_fields
    return jax.vmap(
        lambda aa, bb, cc, ff: encode_block_fields(aa, bb, cc, ff,
                                                   block_type)
    )(a, b, cnt, bfinal)


@functools.partial(jax.jit, static_argnames=())
def _pack_batch(values, widths):
    from .bitpack import pack_fields
    return jax.vmap(pack_fields)(values, widths)


#: shared-table litlen code-length cap.  A 10-bit cap bounds the sync
#: decoder's litlen root table at 1024 entries (4 KiB, which stays
#: cache-resident) for a ratio cost of about 0.04% (package-merge
#: redistributes the tail symbols).  The value was tuned for an earlier
#: decoder; re-tuning it for the current one is open (ROADMAP).
SHARED_MAX_LEN = 10


def _shared_stats(a, b, valid, max_len: int = SHARED_MAX_LEN):
    """Batch-global histogram -> one shared code set + encoder tables."""
    from .deflate_encode import _encoder_tables, token_histograms_masked
    from .huffman import package_merge_lengths

    lit_freq, dist_freq = jax.vmap(token_histograms_masked)(a, b, valid)
    lit_lengths = package_merge_lengths(jnp.sum(lit_freq, axis=0), max_len)
    # the distance alphabet is 30 symbols: an 8-bit cap costs <0.1%
    # ratio and bounds the decoder's distance root at 256 entries
    dist_lengths = package_merge_lengths(jnp.sum(dist_freq, axis=0),
                                         min(max_len, 8))
    lit_rev, lit_w = _encoder_tables(lit_lengths)
    dist_rev, dist_w = _encoder_tables(dist_lengths)
    return lit_lengths, dist_lengths, lit_rev, lit_w, dist_rev, dist_w


def _fields_batch_shared(a, b, cnt, max_len: int = SHARED_MAX_LEN):
    """Field build with ONE shared Huffman table for the whole batch.

    The batch-global histogram yields a single litlen/dist code set that
    every member's header transmits identically (streams stay 100%
    standard; headers across members become byte-identical), so the
    decoder builds one table per batch.  ``max_len`` (SHARED_MAX_LEN)
    bounds the code length; every member is one final block.
    """
    from .deflate_encode import dynamic_header_fields, token_fields_xla

    bsz, m = a.shape
    valid = jnp.arange(m, dtype=jnp.int32)[None, :] < cnt[:, None]
    with jax.named_scope("lf_huffman"):
        (lit_lengths, dist_lengths, lit_rev, lit_w,
         dist_rev, dist_w) = _shared_stats(a, b, valid, max_len)
    with jax.named_scope("lf_fields"):
        hdrv, hdrw, lenv, lenw = dynamic_header_fields(
            lit_lengths, dist_lengths, jnp.int32(1))
        f1v, f1w, f2v, f2w = jax.vmap(
            lambda aa, bb, vv: token_fields_xla(
                aa, bb, vv, lit_rev, lit_w, dist_rev, dist_w))(a, b, valid)
        tokv = jnp.stack([f1v, f2v], axis=2).reshape(bsz, 2 * m)
        tokw = jnp.stack([f1w, f2w], axis=2).reshape(bsz, 2 * m)
        rep = lambda t: jnp.broadcast_to(t[None, :], (bsz, t.shape[0]))
        eob = lambda t: jnp.broadcast_to(t[256][None, None], (bsz, 1))
        values = jnp.concatenate([rep(hdrv), rep(lenv), tokv, eob(lit_rev)],
                                 axis=1)
        widths = jnp.concatenate([rep(hdrw), rep(lenw), tokw, eob(lit_w)],
                                 axis=1)
    return values, widths


@functools.partial(jax.jit, static_argnames=("block_type",))
def _encode_batch(blocks: jnp.ndarray, n_valid: jnp.ndarray,
                  bfinal: jnp.ndarray, block_type: str):
    """(B, n) uint8 blocks -> (B, W) uint32 words + (B,) bit counts."""
    a, b, cnt = _tokenize(blocks, n_valid)
    if block_type == "shared":
        values, widths = _fields_batch_shared(a, b, cnt)
    else:
        values, widths = _fields_batch(a, b, cnt, bfinal, block_type)
    return _pack_batch(values, widths)


def _sync_offsets_batch(widths: jnp.ndarray, k: int):
    """Bit offsets of every k-th token boundary from the field widths.

    In the shared/dynamic field layout, token t occupies fields
    [F0 + 2t, F0 + 2t + 2) with F0 = N_HEADER_FIELDS + N_LENGTH_FIELDS.
    Returns (B, S) int32 absolute bit offsets of tokens 0, k, 2k, …
    (S = ceil(max_tokens / k) + 1; entries past a member's token count
    saturate at the end-of-tokens offset).
    """
    from .deflate_encode import N_HEADER_FIELDS, N_LENGTH_FIELDS
    f0 = N_HEADER_FIELDS + N_LENGTH_FIELDS
    m = (widths.shape[1] - f0 - 1) // 2
    slots = -(-m // k) + 1
    idx = f0 + 2 * k * jnp.arange(slots, dtype=jnp.int32)
    idx = jnp.clip(idx, 1, widths.shape[1])
    cum = jnp.cumsum(widths.astype(jnp.int32), axis=1)
    return cum[:, idx - 1]                   # offset of field f = cum[f-1]


@functools.partial(jax.jit, static_argnames=("k", "lazy", "window",
                                             "chain", "lcp_rounds"))
def _encode_batch_sync(blocks: jnp.ndarray, n_valid: jnp.ndarray, k: int,
                       lazy: bool = True, window: int = C.MAX_DISTANCE,
                       chain: int = 1, lcp_rounds: int | None = None):
    """Shared-table batch encode that also returns the sync index.

    Returns (words (B, W), bits (B,), n_tokens (B,), offsets (B, S)) —
    ``offsets[i, j]`` is the absolute bit position of member i's token
    ``k*j`` (the input to the PGZF "LS" subfield / ops.sync_decode).
    """
    a, b, cnt = _tokenize(blocks, n_valid, lazy, window, chain, lcp_rounds)
    values, widths = _fields_batch_shared(a, b, cnt)
    with jax.named_scope("lf_pack"):
        words, bits = _pack_batch(values, widths)
    with jax.named_scope("lf_offsets"):
        offsets = _sync_offsets_batch(widths, k)
    return words, bits, cnt, offsets


@functools.partial(jax.jit, static_argnames=("k", "lazy", "window",
                                             "chain", "lcp_rounds"))
def _encode_batch_sync_packed(blocks: jnp.ndarray, n_valid: jnp.ndarray,
                              k: int, lazy: bool = True,
                              window: int = C.MAX_DISTANCE, chain: int = 1,
                              lcp_rounds: int | None = None):
    """_encode_batch_sync + member CRCs, small outputs packed.

    Returns (words (B, W) uint32, small (B, 3+S) int32) with small rows
    = [bits, n_tokens, crc_f_raw, sync_offsets...], so the host reads
    the per-member scalars with one transfer.  The CRC f-values cover
    the full zero-padded rows; the caller folds the padding out with
    ops.checksum.crc32_from_padded_f.
    """
    from .checksum import crc32_f_rows
    words, bits, cnt, offsets = _encode_batch_sync(
        blocks, n_valid, k, lazy, window, chain, lcp_rounds)
    with jax.named_scope("lf_crc"):
        crc_f = crc32_f_rows(blocks)
    small = jnp.concatenate(
        [bits.astype(jnp.int32)[:, None], cnt.astype(jnp.int32)[:, None],
         crc_f[:, None], offsets.astype(jnp.int32)], axis=1)
    return words, small


@functools.partial(jax.jit, static_argnames=("block_type",))
def _encode_batch_literal(blocks: jnp.ndarray, n_valid: jnp.ndarray,
                          bfinal: jnp.ndarray, block_type: str):
    """Literal-only (no LZ77) batch encode — parity with matcher='none'."""
    n = blocks.shape[1]

    def one(block, nv, bf):
        a = block.astype(jnp.int32)
        b = jnp.zeros((n,), jnp.int32)
        return encode_block(a, b, nv, bf, block_type)

    return jax.vmap(one)(blocks, n_valid, bfinal)


def deflate_device(data: bytes, options=None,
                   device_block_size: int | None = None) -> bytes:
    """Compress to a complete raw DEFLATE stream on the device."""
    from ..serial.deflate import EncodeOptions
    opts = options or EncodeOptions()
    if opts.block_type == "stored":
        from ..serial.deflate import deflate as _serial_deflate
        return _serial_deflate(bytes(data), opts)

    raw = np.frombuffer(bytes(data), np.uint8)
    bs = min(opts.block_size, device_block_size or DEVICE_BLOCK_SIZE)
    n_blocks = max(1, -(-len(raw) // bs))
    b_pad = 1 << (n_blocks - 1).bit_length()

    blocks = np.zeros((b_pad, bs), np.uint8)
    n_valid = np.zeros((b_pad,), np.int32)
    for i in range(n_blocks):
        chunk = raw[i * bs:(i + 1) * bs]
        blocks[i, :len(chunk)] = chunk
        n_valid[i] = len(chunk)
    bfinal = np.zeros((b_pad,), np.int32)
    bfinal[n_blocks - 1] = 1

    fn = (_encode_batch_literal if opts.matcher == "none"
          else _encode_batch)
    words, bits = fn(jnp.asarray(blocks), jnp.asarray(n_valid),
                     jnp.asarray(bfinal), opts.block_type)
    words = np.asarray(words[:n_blocks])
    bits = np.asarray(bits[:n_blocks])
    return splice_blocks_host(words, bits)


def _register_engine() -> None:
    from .. import backend
    from ..utils import checksum as ck
    from .checksum import adler32_jax, crc32_jax

    def _crc32(data, crc=0):
        arr = jnp.asarray(np.frombuffer(bytes(data), np.uint8))
        v = int(crc32_jax(arr))
        if crc:
            v = ck.crc32_combine(crc, v, len(data))
        return v

    def _adler32(data, adler=1):
        arr = jnp.asarray(np.frombuffer(bytes(data), np.uint8))
        v = int(adler32_jax(arr))
        if adler != 1:
            v = ck.adler32_combine(adler, v, len(data))
        return v

    from .deflate_decode import inflate_device

    backend.register(backend.Engine(
        name="tpu",
        deflate=lambda data, opts=None: deflate_device(bytes(data), opts),
        inflate=lambda data: inflate_device(bytes(data)),
        crc32=_crc32,
        adler32=_adler32,
    ))


_register_engine()
