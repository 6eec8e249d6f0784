"""PGZF — parallel gzip: multi-member gzip with a member-size index.

The framework's scale-out container.  Input is split into fixed-size
chunks; every chunk becomes an independent, fully standard gzip member
whose header carries an EXTRA subfield (id ``b"LF"``, payload = u32 LE
total member byte length).  Properties:

* **100% gzip-compatible** — any stock tool (or the reference's
  MultiDecoder, src/gzip.rs:1052-1167) decodes a PGZF stream unchanged;
  the index subfield rides the standard FEXTRA mechanism
  (≙ ExtraField, src/gzip.rs:466-541).  Same trick as htslib's BGZF.
* **Boundary discovery without decoding** — member starts are found by
  jumping sizes, so decode parallelizes across members (chips, cores,
  lanes) with zero speculation.
* **Per-member CRC/ISIZE** keeps fault isolation: a corrupt shard is
  detected and reported by member index.

Encode: members are tokenized + entropy-coded as one batched device
call; CRCs are computed by the batched GF(2) kernel; headers/trailers
are assembled on the host (byte-scale work).
"""
from __future__ import annotations

import functools
import os
import struct
from dataclasses import dataclass

import numpy as np

from ..spec import constants as C
from . import gzip as fgzip

INDEX_ID = b"LF"
SYNC_ID = b"LS"
DEFAULT_MEMBER_SIZE = 64 * 1024


def _member_header(member_len_placeholder: int, mtime: int = 0,
                   sync_payload: bytes | None = None) -> bytes:
    """Indexed member header: LF (member size) + optional LS (sync index).

    LF must stay first — its u32 size slot sits at a fixed offset
    (_SIZE_OFFSET) so the assembled member can be patched in place."""
    subs = [fgzip.ExtraSubField(INDEX_ID,
                                struct.pack("<I", member_len_placeholder))]
    if sync_payload is not None:
        subs.append(fgzip.ExtraSubField(SYNC_ID, sync_payload))
    hdr = fgzip.Header(mtime=mtime, os=C.GZIP_OS_UNIX,
                       extra=fgzip.ExtraField(subs))
    return hdr.encode()


_HEADER_LEN = len(_member_header(0))
_SIZE_OFFSET = _HEADER_LEN - 4          # u32 sits at the end of EXTRA


def _sync_payload(k: int, n_tokens: int, offsets: np.ndarray) -> bytes:
    """Serialize the "LS" sync-index subfield.

    Layout (LE): u8 version=1 | u8 flags=0 | u16 K | u32 n_tokens |
    u32 first_bit | u16 n_chunks | u16 deltas[n_chunks-1] — deltas are
    bit distances between consecutive chunk starts (each covers K
    tokens; max 42-bit tokens keep K*42 < 2^16 for K <= 1024).
    """
    n_chunks = max(0, -(-n_tokens // k))
    first_bit = int(offsets[0])
    deltas64 = (np.diff(offsets[:n_chunks]).astype(np.int64)
                if n_chunks > 1 else np.zeros(0, np.int64))
    if len(deltas64) and int(deltas64.max()) > 0xFFFF:
        # cannot happen for this encoder (K*42-bit worst-case symbols
        # < 2^16 for K <= 1024) — guard against silent u16 wrap anyway
        return None
    return (struct.pack("<BBHIIH", 1, 0, k, n_tokens, first_bit, n_chunks)
            + deltas64.astype("<u2").tobytes())


def _chunk_spans(sync, ref: "MemberRef"):
    """Validated chunk spans for one member's LS index.

    Returns (starts, ends, counts) int64 arrays of bit offsets relative
    to the member body / token counts per chunk.  Raises DeflateError on
    a corrupt or empty index.
    """
    from ..serial.deflate import DeflateError
    k, n_tokens, first_bit, n_chunks, deltas = sync
    body_bits = (ref.end - 8 - ref.body) * 8
    if n_chunks <= 0 or n_tokens <= 0 or n_chunks != -(-n_tokens // k):
        raise DeflateError("empty or inconsistent sync index")
    starts = np.zeros(n_chunks, np.int64)
    starts[0] = first_bit
    if n_chunks > 1:
        starts[1:] = first_bit + np.cumsum(deltas.astype(np.int64))
    ends = np.empty(n_chunks, np.int64)
    ends[:-1] = starts[1:]
    ends[-1] = body_bits
    if (ends < starts).any() or starts[-1] >= body_bits:
        raise DeflateError("corrupt sync index")
    counts = np.minimum(k, n_tokens - k * np.arange(n_chunks, dtype=np.int64))
    return starts, ends, counts


def _tracer():
    """StageTimer when LIBFLATE_TRACE is set (utils.profiling); else None."""
    import os
    if not os.environ.get("LIBFLATE_TRACE"):
        return None
    from ..utils.profiling import StageTimer
    return StageTimer()


def _maybe_stage(timer, name: str):
    import contextlib
    return timer.stage(name) if timer else contextlib.nullcontext()


def _trace_report(timer, label: str) -> None:
    if timer:
        import sys
        print(f"[libflate-trace] {label}\n{timer.report()}",
              file=sys.stderr, flush=True)


def _maybe_jax_trace():
    """LIBFLATE_TRACE=jax wraps the codec call in a jax.profiler trace
    (SURVEY §5 tracing parity; view with TensorBoard/xprof at
    LIBFLATE_TRACE_DIR, by default libflate_trace under the temporary
    directory).  Any other value keeps the lightweight wall-clock
    StageTimer only."""
    import contextlib
    import tempfile
    if os.environ.get("LIBFLATE_TRACE") != "jax":
        return contextlib.nullcontext()
    from ..utils.profiling import device_trace
    return device_trace(os.environ.get(
        "LIBFLATE_TRACE_DIR",
        os.path.join(tempfile.gettempdir(), "libflate_trace")))


def _parse_sync(hdr: "fgzip.Header"):
    """Parse an LS subfield; None when absent/foreign/malformed."""
    if hdr.extra is None:
        return None
    for sub in hdr.extra.subfields:
        if sub.id != SYNC_ID or len(sub.data) < 14:
            continue
        ver, _flags, k, n_tokens, first_bit, n_chunks = struct.unpack_from(
            "<BBHIIH", sub.data, 0)
        if ver != 1 or k == 0 or k > 1024:
            return None
        if len(sub.data) != 14 + 2 * max(0, n_chunks - 1):
            return None
        deltas = np.frombuffer(sub.data, "<u2", offset=14)
        return k, n_tokens, first_bit, n_chunks, deltas
    return None


def _device_handles(opts) -> bool:
    """Whether the device encoder supports these options (it emits
    compressed members only)."""
    return opts.matcher != "none" and opts.block_type != "stored"


def compress(data: bytes, member_size: int = DEFAULT_MEMBER_SIZE,
             options=None, engine: str | None = None,
             n_threads: int = 0) -> bytes:
    """Compress into an indexed multi-member gzip stream.

    Engines: "tpu" (the device engine: block-parallel encode on the
    accelerator; a device failure raises), "native" (threaded C++),
    None/"auto" (native if available, else the device engine when an
    accelerator is present, else serial).

    Example (any stock gzip tool can read the result, and decode
    parallelizes over members):

        >>> data = b"to be or not to be, " * 4096
        >>> stream = compress(data, member_size=16 * 1024)
        >>> decompress(stream) == data
        True
        >>> import gzip as stdgz                  # stock-tool check
        >>> stdgz.decompress(stream) == data
        True
    """
    from ..ops import device
    from ..serial.deflate import EncodeOptions

    data = bytes(data)
    # default: lazy + hash-chain matching at depth 128 (zlib-6-class).
    # matcher="greedy" matches the reference's single-candidate
    # strategy, matcher="lazy" is the chainless middle ground,
    # matcher="chain" honours options.max_chain.
    matcher = getattr(options, "matcher", "") if options else ""
    lazy = matcher != "greedy"
    if matcher == "chain":
        max_chain = getattr(options, "max_chain", 128)
    elif matcher in ("greedy", "lazy"):
        max_chain = 1
    else:
        max_chain = 128
    if engine in ("native", None, "auto"):
        try:
            return _compress_native(data, member_size, n_threads, lazy,
                                    max_chain)
        except ImportError:
            if engine == "native":
                raise
    opts = options or EncodeOptions()
    if _device_handles(opts) and (
            engine == "tpu" or (engine in (None, "auto")
                                and device.has_accelerator())):
        with _maybe_jax_trace():
            return _compress_device(data, member_size, opts)
    chunks = [data[i:i + member_size]
              for i in range(0, max(len(data), 1), member_size)]
    out = bytearray()
    for chunk in chunks:
        body = fgzip.compress(chunk, options=options, engine=engine)
        # re-wrap with indexed header
        member = _reheader(body, chunk)
        out += member
    return bytes(out)


def _compress_native(data: bytes, member_size: int,
                     n_threads: int = 0, lazy: bool = False,
                     max_chain: int = 1) -> bytes:
    from .. import native
    if not native.available():
        raise ImportError("native engine unavailable")
    n = len(data)
    n_members = max(1, -(-n // member_size))
    offs = np.zeros(n_members + 1, np.uint64)
    for i in range(n_members):
        offs[i + 1] = min(n, (i + 1) * member_size)
    bodies, crcs = native.deflate_batch(data, offs, n_threads=n_threads,
                                        lazy=lazy, max_chain=max_chain)
    out = bytearray()
    for i in range(n_members):
        nv = int(offs[i + 1] - offs[i])
        member = bytearray(_member_header(0))
        member += bodies[i]
        member += struct.pack("<II", int(crcs[i]), nv)
        struct.pack_into("<I", member, _SIZE_OFFSET, len(member))
        out += member
    return bytes(out)


def _reheader(plain_gzip: bytes, chunk: bytes) -> bytes:
    # strip the 10-byte plain header, prepend indexed header, patch size
    payload = plain_gzip[10:]
    member = bytearray(_member_header(0) + payload)
    struct.pack_into("<I", member, _SIZE_OFFSET, len(member))
    return bytes(member)


#: members per device encode batch.  The members of one batch share one
#: Huffman table (the shared-table encoder's batch-global histogram), so
#: this constant is part of what the encoder writes: changing it changes
#: the stream.  Every call compiles this one batch shape.
DEV_BATCH = 128


def _compress_device(data: bytes, member_size: int, opts) -> bytes:
    import jax.numpy as jnp

    from ..ops.checksum import crc32_f_rows, crc32_from_padded_f
    from ..ops.deflate_encode import splice_blocks_host
    from ..ops.pipeline import (_device_knobs, _encode_batch,
                                _encode_batch_sync_packed)
    from ..ops.sync_decode import SYNC_TOKENS
    from ..serial.deflate import EncodeOptions
    from ..serial.deflate import deflate as serial_deflate

    n = len(data)
    raw = np.frombuffer(data, np.uint8)
    n_members = max(1, -(-n // member_size))
    n_batches = -(-n_members // DEV_BATCH)
    b_pad = n_batches * DEV_BATCH

    blocks = np.zeros((b_pad, member_size), np.uint8)
    n_valid = np.zeros((b_pad,), np.int32)
    full = n // member_size
    blocks[:full] = raw[:full * member_size].reshape(full, member_size)
    n_valid[:full] = member_size
    if full < n_members:
        blocks[full, :n - full * member_size] = raw[full * member_size:]
        n_valid[full] = n - full * member_size
    bfinal = jnp.ones((DEV_BATCH,), jnp.int32)  # every member: 1 block

    # shared-table mode: one batch-global Huffman code set, transmitted
    # identically in every member header, plus the "LS" sync index the
    # device decoder consumes; 100% standard gzip either way.  The
    # member-level stored fallback below covers incompressible chunks.
    btype = "shared" if opts.block_type == "dynamic" else opts.block_type
    sync = btype == "shared"
    knobs = _device_knobs(opts)

    def _dispatch(g):
        """Launch batch g's device compute (async dispatch)."""
        sl = slice(g * DEV_BATCH, (g + 1) * DEV_BATCH)
        blocks_j = jnp.asarray(blocks[sl])
        nv_j = jnp.asarray(n_valid[sl])
        if sync:
            return _encode_batch_sync_packed(blocks_j, nv_j, SYNC_TOKENS,
                                             **knobs)
        words, bits = _encode_batch(blocks_j, nv_j, bfinal, btype)
        return words, (bits, crc32_f_rows(blocks_j))

    # Double-buffered dispatch/drain: batch g+1's device compute
    # overlaps batch g's D2H drain, and at most TWO batches' device
    # buffers are live at once.
    words_l, bits_l, crcs_l, cnt_l, offs_l = [], [], [], [], []
    pend = {0: _dispatch(0)}
    for g in range(n_batches):
        if g + 1 < n_batches:
            pend[g + 1] = _dispatch(g + 1)
        sl = slice(g * DEV_BATCH, (g + 1) * DEV_BATCH)
        w, rest = pend.pop(g)
        if sync:
            small = np.asarray(rest)
            bts_np, crc_f = small[:, 0], small[:, 2]
            cnt_l.append(small[:, 1])
            offs_l.append(small[:, 3:])
        else:
            bts_np, crc_f = map(np.asarray, rest)
        crcs_l.append(crc32_from_padded_f(crc_f, n_valid[sl], member_size))
        wmax = int(bts_np.max(initial=1) + 31) // 32 + 1
        wmax = min(-(-wmax // 2048) * 2048, w.shape[1])
        words_l.append(np.asarray(w[:, :wmax]))
        bits_l.append(bts_np)
    bits = np.concatenate(bits_l, axis=0)
    crcs = np.concatenate(crcs_l, axis=0)

    out = bytearray()
    for i in range(n_members):
        g, r = divmod(i, DEV_BATCH)
        body = splice_blocks_host(words_l[g][r:r + 1], bits[i:i + 1])
        nv = int(n_valid[i])
        sync_payload = None
        if sync and int(cnt_l[g][r]) > 0:
            sync_payload = _sync_payload(SYNC_TOKENS, int(cnt_l[g][r]),
                                         offs_l[g][r])
        stored_size = nv + 5 * max(1, -(-nv // C.MAX_STORED_BLOCK))
        if len(body) >= stored_size:
            # incompressible member: stored blocks beat entropy coding
            raw_member = raw[i * member_size:i * member_size + nv].tobytes()
            body = serial_deflate(raw_member,
                                  EncodeOptions(block_type="stored"))
            sync_payload = None
        member = bytearray(_member_header(0, sync_payload=sync_payload))
        member += body
        member += struct.pack("<II", int(crcs[i]), nv)
        struct.pack_into("<I", member, _SIZE_OFFSET, len(member))
        out += member
    return bytes(out)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
@dataclass
class MemberRef:
    start: int          # byte offset of the member
    end: int            # byte offset one past the member
    body: int           # byte offset of the DEFLATE payload


def index_members(data: bytes) -> list[MemberRef] | None:
    """Walk the LF index without decoding; None if any member lacks it."""
    refs = []
    pos = 0
    while pos < len(data):
        try:
            hdr, body = fgzip.Header.decode(data, pos)
        except (fgzip.GzipError, EOFError):
            return None
        size = None
        if hdr.extra is not None:
            for sub in hdr.extra.subfields:
                if sub.id == INDEX_ID and len(sub.data) == 4:
                    (size,) = struct.unpack("<I", sub.data)
        if size is None or size <= 0 or pos + size > len(data):
            return None
        refs.append(MemberRef(pos, pos + size, body))
        pos += size
    return refs


def decompress(data: bytes, engine: str | None = None,
               verify: bool = True, n_threads: int = 0) -> bytes:
    """Decompress a gzip stream; uses a member-parallel path (threaded
    native or device batch) when the LF index is present, else falls
    back to sequential MultiDecoder.

    ``engine="tpu"`` decodes the symbols on the device (the sync-index
    kernel when the stream carries "LS" indices) and raises on a device
    failure; None/"auto" prefer the native engine.

    Works on FOREIGN streams too (no index, any producer):

        >>> import gzip as stdgz
        >>> decompress(stdgz.compress(b"banana" * 999)) == b"banana" * 999
        True
    """
    from ..ops import device

    data = bytes(data)
    if engine in ("native", None, "auto"):
        # fully-native fast path: the C walk indexes the LF subfields and
        # the scatter-offset batch decode reads bodies in place (no
        # Python header loop, no payload join)
        try:
            from .. import native
            if native.available():
                idx = native.pgzf_index(data)
                if idx is not None:
                    starts, ends, crcs_expected, isizes = idx
                    out, crcs = native.inflate_batch_at(
                        data, starts, ends, isizes, n_threads=n_threads)
                    if verify and (crcs != crcs_expected).any():
                        bad = int(np.argmax(crcs != crcs_expected))
                        raise fgzip.GzipError(
                            f"gzip CRC mismatch in member {bad}: stream "
                            f"says {int(crcs_expected[bad]):#010x}, "
                            f"computed {int(crcs[bad]):#010x}")
                    return out
        except ImportError:
            pass
    refs = index_members(data)
    if refs is None:
        return fgzip.decompress(data, engine=engine, multi=True)
    if engine in ("native", None, "auto"):
        try:
            return _decompress_native(data, refs, verify, n_threads)
        except ImportError:
            pass
    if engine == "tpu" or (engine in (None, "auto")
                           and device.has_accelerator()):
        with _maybe_jax_trace():
            plan = _sync_plan(data, refs)
            if plan is not None:
                return _decompress_sync_device(data, refs, plan, verify)
            try:
                return _decompress_device(data, refs, verify)
            except ImportError:
                if engine == "tpu":
                    raise
    return fgzip.decompress(data, engine=engine, multi=True)


def _decompress_native(data: bytes, refs: list[MemberRef],
                       verify: bool, n_threads: int = 0) -> bytes:
    from .. import native
    if not native.available():
        raise ImportError("native engine unavailable")
    bsz = len(refs)
    bodies = b"".join(data[r.body:r.end - 8] for r in refs)
    offs = np.zeros(bsz + 1, np.uint64)
    isizes = np.zeros(bsz, np.uint64)
    crcs_expected = np.zeros(bsz, np.uint32)
    for i, r in enumerate(refs):
        offs[i + 1] = offs[i] + (r.end - 8 - r.body)
        crcs_expected[i], isizes[i] = struct.unpack_from("<II", data,
                                                         r.end - 8)
    out, crcs = native.inflate_batch(bodies, offs, isizes,
                                     n_threads=n_threads)
    if verify and (crcs != crcs_expected).any():
        bad = int(np.argmax(crcs != crcs_expected))
        raise fgzip.GzipError(
            f"gzip CRC mismatch in member {bad}: stream says "
            f"{int(crcs_expected[bad]):#010x}, computed "
            f"{int(crcs[bad]):#010x}")
    return out


@dataclass
class SyncPlan:
    """Host staging for the sync-index device decode of one stream.

    Members whose block is one final dynamic block with an "LS" index,
    code lengths within the sync decoder's roots and the common chunk
    size K are ``device_ok``; the others (stored fallbacks, foreign
    members) decode on the host.  Chunk arrays have a uniform stride of
    ``max_nc`` slots per member, so the decoder's chunk-major tokens
    reshape into member-major rows with no gather.  ``lo``/``hi`` bound
    the cursor after each chunk's last token (relative to bit 0 of its
    start word): exactly the next chunk's start for inner chunks, at
    most the body end for a member's last chunk.
    """
    words: np.ndarray          # (W,) uint32 stream words
    device_ok: np.ndarray      # (n,) bool
    isizes: np.ndarray         # (n,) int64
    crcs_expected: np.ndarray  # (n,) uint32
    n_tokens: np.ndarray       # (n,) int32
    table: np.ndarray          # (n,) int32 code-table group per member
    lit_lengths: np.ndarray    # (G, 286) int32
    dist_lengths: np.ndarray   # (G, 30) int32
    chunk_word: np.ndarray     # (n, max_nc) int32
    chunk_bit: np.ndarray      # (n, max_nc) int32
    counts: np.ndarray         # (n, max_nc) int32
    lo: np.ndarray             # (n, max_nc) int32
    hi: np.ndarray             # (n, max_nc) int32
    k_tok: int
    root_bits: int
    member_cap: int


def _sync_plan(data: bytes, refs: list[MemberRef]) -> SyncPlan | None:
    """Parse the LS indices and block headers; None when no member can
    take the device sync decode."""
    from .. import native
    from ..ops import sync_decode as sd
    from ..serial.deflate import DeflateError

    n = len(refs)
    isizes = np.zeros((n,), np.int64)
    crcs = np.zeros((n,), np.uint32)
    syncs: list = [None] * n
    for i, ref in enumerate(refs):
        crcs[i], isizes[i] = struct.unpack_from("<II", data, ref.end - 8)
        hdr, _ = fgzip.Header.decode(data, ref.start)
        syncs[i] = _parse_sync(hdr)
    if all(s is None for s in syncs):
        return None
    if not native.available():
        raise ImportError("the sync decode needs the native header parser")
    bodies = b"".join(data[r.body:r.end - 8] for r in refs)
    offs = np.zeros(n + 1, np.uint64)
    offs[1:] = np.cumsum([r.end - 8 - r.body for r in refs])
    lit_ls, dist_ls, starts64, flags = native.parse_dyn_headers(bodies,
                                                                offs)
    k_tok = next(s[0] for s in syncs if s is not None)
    ok = np.array(
        [s is not None and s[0] == k_tok and s[1] > 0
         and int(s[2]) == int(starts64[i]) for i, s in enumerate(syncs)])
    ok &= ((flags == (1 | (C.BTYPE_DYNAMIC << 1)))
           & (lit_ls.max(axis=1) <= sd.ROOT_BITS)
           & (dist_ls.max(axis=1) <= sd.DIST_ROOT_BITS))
    spans: list = [None] * n
    for i in np.nonzero(ok)[0]:
        try:
            spans[i] = _chunk_spans(syncs[i], refs[i])
        except DeflateError as e:
            raise DeflateError(f"member {i}: {e}") from e
    if not ok.any():
        return None

    # contiguous members with identical tables share one table group
    table = np.zeros((n,), np.int32)
    groups: list[int] = []
    for i in np.nonzero(ok)[0]:
        if not (groups and (lit_ls[i] == lit_ls[groups[-1]]).all()
                and (dist_ls[i] == dist_ls[groups[-1]]).all()):
            groups.append(int(i))
        table[i] = len(groups) - 1

    max_nc = max(len(spans[i][0]) for i in np.nonzero(ok)[0])
    shape = (n, max_nc)
    chunk_word = np.zeros(shape, np.int32)
    chunk_bit = np.zeros(shape, np.int32)
    counts = np.zeros(shape, np.int32)
    lo = np.zeros(shape, np.int32)
    hi = np.zeros(shape, np.int32)
    n_tokens = np.zeros((n,), np.int32)
    for i in np.nonzero(ok)[0]:
        st, en, co = spans[i]
        nc = len(st)
        ab = refs[i].body * 8 + st
        base = (ab >> 5) << 5
        chunk_word[i, :nc] = ab >> 5
        chunk_bit[i, :nc] = ab & 31
        counts[i, :nc] = co
        hi[i, :nc] = refs[i].body * 8 + en - base
        lo[i, :nc] = hi[i, :nc]
        lo[i, nc - 1] = ab[-1] & 31
        n_tokens[i] = syncs[i][1]
    member_cap = 1 << max(10, (int(isizes.max(initial=1)) - 1).bit_length())
    return SyncPlan(
        words=sd.stream_words(data), device_ok=ok, isizes=isizes,
        crcs_expected=crcs, n_tokens=n_tokens, table=table,
        lit_lengths=lit_ls[groups, :C.MAX_LITLEN_SYMBOLS],
        dist_lengths=dist_ls[groups], chunk_word=chunk_word,
        chunk_bit=chunk_bit, counts=counts, lo=lo, hi=hi, k_tok=k_tok,
        root_bits=max(int(lit_ls[ok].max()), 7), member_cap=member_cap)


#: plaintext bytes one device decode call covers; bounds the expansion's
#: device footprint (about 20 bytes of int32 intermediates per output
#: byte) whatever the stream size
DECODE_BYTES_PER_CALL = 256 << 20


def _member_batches(plan: SyncPlan, members: np.ndarray):
    """Split member indices into equal-shape device calls."""
    per_call = max(1, DECODE_BYTES_PER_CALL // plan.member_cap)
    per_call = min(per_call, 1 << max(0, (len(members) - 1).bit_length()))
    for b0 in range(0, len(members), per_call):
        yield members[b0:b0 + per_call], per_call


def _chunk_args(plan: SyncPlan, idx: np.ndarray, n_pad: int):
    """Per-chunk device arrays for members ``idx`` padded to ``n_pad``
    members (padding members decode zero tokens)."""
    from ..ops.sync_decode import BLOCK

    def take(x):
        out = np.zeros((n_pad, x.shape[1]), x.dtype)
        out[:len(idx)] = x[idx]
        return out.reshape(-1)

    table = np.broadcast_to(plan.table[:, None], plan.chunk_word.shape)
    s = n_pad * plan.chunk_word.shape[1]
    s_pad = -(-s // BLOCK) * BLOCK
    args = [np.pad(take(x), (0, s_pad - s)) for x in
            (plan.chunk_word, plan.chunk_bit, plan.counts, table)]
    return args, take(plan.lo), take(plan.hi)


@functools.cache
def _sync_chain():
    """The jitted device decode chain (built on first use)."""
    import jax
    return jax.jit(_sync_chain_body, static_argnames=(
        "k_tok", "root_bits", "max_nc", "member_cap", "expand"))


def _sync_chain_body(words, chunk_word, chunk_bit, counts, table, lit_t,
                     dist_t, lo, hi, n_tokens, *, k_tok: int,
                     root_bits: int, max_nc: int, member_cap: int,
                     expand: bool):
    """The device decode chain for one member batch, under one jit:
    sync decode -> chunk checks -> member-major token rows, then (with
    ``expand``) LZ77 expansion and member CRC f-values."""
    import jax
    import jax.numpy as jnp

    from ..ops.checksum import crc32_f_rows
    from ..ops.device_expand import expand_members
    from ..ops.sync_decode import sync_decode

    with jax.named_scope("lf_sync_decode"):
        toks, end = sync_decode(words, chunk_word, chunk_bit, counts,
                                table, lit_t, dist_t, k_tokens=k_tok,
                                root_bits=root_bits)
    n_b = n_tokens.shape[0]
    s = n_b * max_nc
    with jax.named_scope("lf_reorder"):
        bad = (end[:s] < lo) | (end[:s] > hi)
        err = jnp.any(bad.reshape(n_b, max_nc), axis=1)
        packed = toks.T[:s].reshape(n_b, max_nc * k_tok)
    if not expand:
        return packed, err
    with jax.named_scope("lf_expand"):
        plain, _n_out, xerr = expand_members(packed, n_tokens, member_cap)
    with jax.named_scope("lf_crc"):
        crc_f = crc32_f_rows(plain)
    return plain, err | xerr, crc_f


def _run_sync_batches(plan: SyncPlan, members: np.ndarray, expand: bool):
    """Yield (member indices, device results) per _sync_chain call."""
    import jax.numpy as jnp

    from ..ops.sync_decode import decode_tables

    words = jnp.asarray(plan.words)
    lit_t, dist_t = decode_tables(plan.lit_lengths, plan.dist_lengths,
                                  plan.root_bits)
    for idx, n_pad in _member_batches(plan, members):
        args, lo, hi = _chunk_args(plan, idx, n_pad)
        nt = np.zeros((n_pad,), np.int32)
        nt[:len(idx)] = plan.n_tokens[idx]
        yield idx, _sync_chain()(
            words, *map(jnp.asarray, args), lit_t, dist_t,
            jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(nt),
            k_tok=plan.k_tok, root_bits=plan.root_bits,
            max_nc=plan.chunk_word.shape[1], member_cap=plan.member_cap,
            expand=expand)


def _decompress_sync_device(data: bytes, refs: list[MemberRef],
                            plan: SyncPlan, verify: bool) -> bytes:
    """Sync-indexed decode: symbols on the device (ops/sync_decode),
    then the threaded native engine expands the tokens.  Members the
    device cannot take (``~plan.device_ok``: stored fallbacks, foreign
    members) decode on the host."""
    from .. import native
    from ..serial.deflate import DeflateError
    from .gzip import GzipError

    timer = _tracer()
    n = len(refs)
    pieces: list[bytes | None] = [None] * n
    for i in np.nonzero(~plan.device_ok)[0]:
        body = data[refs[i].body:refs[i].end - 8]
        pieces[i], _ = native.inflate(body,
                                      initial_cap=int(plan.isizes[i]) + 64)
        if len(pieces[i]) != int(plan.isizes[i]):
            raise GzipError(f"gzip ISIZE mismatch in member {i}")
        if verify and native.crc32(pieces[i]) != int(plan.crcs_expected[i]):
            raise GzipError(f"gzip CRC mismatch in member {i}")

    dev = np.nonzero(plan.device_ok)[0]
    for idx, (packed, err) in _run_sync_batches(plan, dev, expand=False):
        with _maybe_stage(timer, "device decode+D2H"):
            err = np.asarray(err)[:len(idx)]
            packed = np.asarray(packed)[:len(idx)]
        if err.any():
            raise DeflateError(f"corrupt sync index or bitstream in "
                               f"member {int(idx[np.argmax(err)])}")
        with _maybe_stage(timer, "native expand+crc"):
            blob, crcs = native.expand_batch(
                packed, None, plan.n_tokens[idx].astype(np.int64),
                plan.isizes[idx])
        pos = 0
        for k, i in enumerate(idx):
            pieces[i] = blob[pos:pos + int(plan.isizes[i])]
            pos += int(plan.isizes[i])
            if verify and int(crcs[k]) != int(plan.crcs_expected[i]):
                raise GzipError(f"gzip CRC mismatch in member {i}")
    _trace_report(timer, "sync decode")
    return b"".join(pieces)  # type: ignore[arg-type]


def host_members(data: bytes) -> int:
    """How many members of an indexed stream the sync device decode
    hands to the host (stored fallbacks, foreign members); 0 for a
    stream without the index."""
    refs = index_members(bytes(data))
    plan = _sync_plan(bytes(data), refs) if refs is not None else None
    return 0 if plan is None else int((~plan.device_ok).sum())


def decompress_to_device(data: bytes, verify: bool = False):
    """Decode a gzip stream INTO device memory.

    Example (the decompress-into-training-batch shape)::

        stream = pgzf.compress(corpus, member_size=64 * 1024)
        plain, lens = pgzf.decompress_to_device(stream)   # no D2H
        batch = plain[:, :crop]            # feed the data pipeline

    Sync-indexed PGZF streams decode entirely on the device: symbol
    decode (ops/sync_decode), member-major token rows, LZ77 expansion
    (ops/device_expand) and CRC.  Any other stream (stdlib gzip, pigz,
    this framework's native encoder) takes the foreign bridge: the C
    engine decodes tokens, the device expands them.  Returns ``(out,
    lengths)``: ``out`` is a (n_members, member_cap) uint8 device
    array, row i holding member i's plaintext in ``out[i, :lengths[i]]``.
    ``verify=True`` checks every member CRC.  Device failures raise.
    """
    import jax.numpy as jnp

    from ..ops.checksum import crc32_from_padded_f
    from ..serial.deflate import DeflateError
    from .gzip import GzipError

    data = bytes(data)
    refs = index_members(data)
    plan = _sync_plan(data, refs) if refs is not None else None
    if plan is None or not plan.device_ok.all():
        return _foreign_to_device(data, verify, refs)
    plains = []
    for idx, (plain, err, crc_f) in _run_sync_batches(
            plan, np.arange(len(refs)), expand=True):
        err = np.asarray(err)[:len(idx)]
        if err.any():
            raise DeflateError(f"device decode failed in member "
                               f"{int(idx[np.argmax(err)])}")
        if verify:
            crcs = crc32_from_padded_f(np.asarray(crc_f)[:len(idx)],
                                       plan.isizes[idx], plan.member_cap)
            bad = crcs != plan.crcs_expected[idx]
            if bad.any():
                raise GzipError(f"gzip CRC mismatch in member "
                                f"{int(idx[np.argmax(bad)])}")
        plains.append(plain[:len(idx)])
    out = plains[0] if len(plains) == 1 else jnp.concatenate(plains)
    return out, jnp.asarray(plan.isizes, jnp.int32)


def _foreign_to_device(data: bytes, verify: bool,
                       refs: list[MemberRef] | None = None):
    """decompress_to_device tail for FOREIGN streams — members with
    their own per-member dynamic (or fixed/stored) tables, no LS index,
    any producer (stdlib gzip, zlib CLI, pigz...).

    The sequential entropy phase runs in the threaded C engine as a
    TOKEN decode (native.inflate_tokens_batch — no byte
    materialization); LZ77 expansion and CRC run on the device
    (ops/device_expand), in calls of DECODE_BYTES_PER_CALL plaintext.
    Covers the reference's arbitrary-stream decode capability
    (src/deflate/decode.rs:136-164) with device-resident output.
    """
    import jax.numpy as jnp

    from .. import native
    from ..ops.checksum import crc32_f_rows, crc32_from_padded_f
    from ..ops.device_expand import expand_members
    from ..serial.deflate import DeflateError
    from .gzip import GzipError

    if not native.available():
        raise ImportError("foreign device decode needs the C engine")

    if refs is not None:
        # indexed stream: extents are known, so the token decode runs
        # threaded
        sizes, crcs_expected = [], []
        for ref in refs:
            c, s = struct.unpack_from("<II", data, ref.end - 8)
            sizes.append(s)
            crcs_expected.append(c)
        t_cap = max(1024, -(-max(max(sizes), 1) // 1024) * 1024)
        packed, counts, osz = native.inflate_tokens_batch(
            data, [r.body for r in refs], [r.end - 8 for r in refs],
            t_cap)
        if (osz.astype(np.int64) != np.asarray(sizes)).any():
            raise GzipError("gzip ISIZE mismatch")
        nt = counts.astype(np.int32)
    else:
        # un-indexed: extents come from the token decoder's end bit
        # (sequential, but it IS the decode)
        sizes, crcs_expected, toks_l = [], [], []
        pos = 0
        while pos < len(data):
            hdr, body = fgzip.Header.decode(data, pos)
            cap = 1 << 17
            while True:
                r = native.inflate_tokens(data, body, cap)
                if r is not None:
                    break
                cap *= 4
                if cap > (len(data) - body) * 9 + 4096:
                    raise DeflateError("token decode cap overrun")
            toks, osize, eb = r
            end_byte = body + (eb + 7) // 8
            if end_byte + 8 > len(data):
                raise GzipError(
                    "truncated gzip member (missing trailer)")
            crc_exp, isize = struct.unpack_from("<II", data, end_byte)
            if isize != (osize & 0xFFFFFFFF):
                raise GzipError(
                    f"gzip ISIZE mismatch in member {len(sizes)}")
            sizes.append(osize)
            crcs_expected.append(crc_exp)
            toks_l.append(toks)
            pos = end_byte + 8
        if not toks_l:
            raise DeflateError("empty gzip stream")
        t_cap = max(1024, -(-max(len(t) for t in toks_l) // 1024) * 1024)
        packed = np.zeros((len(toks_l), t_cap), np.int32)
        nt = np.zeros((len(toks_l),), np.int32)
        for i, t in enumerate(toks_l):
            packed[i, :len(t)] = t
            nt[i] = len(t)

    sizes = np.asarray(sizes, np.int64)
    out_cap = 1 << max(10, (int(sizes.max(initial=1)) - 1).bit_length())
    per_call = max(1, DECODE_BYTES_PER_CALL // out_cap)
    plains = []
    for b0 in range(0, len(sizes), per_call):
        plain, _n_out, err = expand_members(
            jnp.asarray(packed[b0:b0 + per_call]),
            jnp.asarray(nt[b0:b0 + per_call]), out_cap)
        if bool(np.asarray(err).any()):
            raise DeflateError("bad back-reference in device expansion")
        if verify:
            crcs = crc32_from_padded_f(np.asarray(crc32_f_rows(plain)),
                                       sizes[b0:b0 + per_call], out_cap)
            bad = crcs != np.asarray(crcs_expected[b0:b0 + per_call],
                                     np.uint32)
            if bad.any():
                raise GzipError(f"gzip CRC mismatch in member "
                                f"{b0 + int(np.argmax(bad))}")
        plains.append(plain)
    out = plains[0] if len(plains) == 1 else jnp.concatenate(plains)
    return out, jnp.asarray(sizes, jnp.int32)


def _decompress_device(data: bytes, refs: list[MemberRef],
                       verify: bool) -> bytes:
    import jax.numpy as jnp

    from ..ops.checksum import crc32_batch_jax
    from ..ops.deflate_decode import (decode_symbols_chunked,
                                      tables_from_lengths)
    from ..ops.device_expand import expand_tokens
    from ..serial.bitio import BitReader
    from ..serial.deflate import DeflateError, read_dynamic_header_lengths
    from .gzip import GzipError

    bsz = len(refs)
    # host: parse each member's single block header (byte-scale work;
    # native batch parser when available, serial Python otherwise)
    isizes = np.zeros((bsz,), np.int64)
    crcs_expected = np.zeros((bsz,), np.uint32)
    max_body = 0
    for i, ref in enumerate(refs):
        crcs_expected[i], isizes[i] = struct.unpack_from(
            "<II", data, ref.end - 8)
        max_body = max(max_body, ref.end - 8 - ref.body)

    from .. import native
    host_members: dict[int, bytes] = {}
    if native.available():
        bodies = b"".join(data[ref.body:ref.end - 8] for ref in refs)
        offs = np.zeros(bsz + 1, np.uint64)
        for i, ref in enumerate(refs):
            offs[i + 1] = offs[i] + (ref.end - 8 - ref.body)
        lit_ls, dist_ls, starts64, flags = native.parse_dyn_headers(
            bodies, offs)
        starts = starts64.astype(np.int32)
        # members that aren't a single final compressed block (e.g. the
        # stored fallback for incompressible chunks) decode host-side
        device_ok = ((flags == (1 | (C.BTYPE_DYNAMIC << 1))) |
                     (flags == (1 | (C.BTYPE_FIXED << 1))))
        for i in np.nonzero(~device_ok)[0]:
            body = data[refs[i].body:refs[i].end - 8]
            host_members[int(i)], _ = native.inflate(
                body, initial_cap=int(isizes[i]) + 64)
    else:
        lit_ls = np.zeros((bsz, 288), np.int32)
        dist_ls = np.zeros((bsz, C.MAX_DIST_SYMBOLS), np.int32)
        starts = np.zeros((bsz,), np.int32)
        for i, ref in enumerate(refs):
            body = data[ref.body:ref.end - 8]
            r = BitReader(body)
            final = r.read_bits(1)
            btype = r.read_bits(2)
            if not final or btype != C.BTYPE_DYNAMIC:
                # not our single-dynamic-block shape: fall back entirely
                raise ImportError("non-canonical member layout")
            lit_ls[i, :C.MAX_LITLEN_SYMBOLS], dist_ls[i] = \
                read_dynamic_header_lengths(r)
            starts[i] = r.bit_position

    out_cap = int(isizes.max(initial=1)) or 1
    out_cap = 1 << max(8, (out_cap - 1).bit_length())

    dev_idx = [i for i in range(bsz) if i not in host_members]
    pieces: list[bytes | None] = [None] * bsz
    for i, piece in host_members.items():
        if len(piece) != int(isizes[i]):
            raise GzipError(f"gzip ISIZE mismatch in member {i}")
        pieces[i] = piece

    # fixed device batch + out_cap-derived word width: one compiled
    # shape per (member-size class), reused across input sizes
    batch = 64
    w = out_cap // 4 + 512
    if max_body > 4 * (w - 2):
        raise ImportError("member body exceeds device word budget")
    fixed_l = np.asarray(C.fixed_litlen_lengths(),
                         np.int32)[:lit_ls.shape[1]]
    for g in range(0, len(dev_idx), batch):
        group = dev_idx[g:g + batch]
        words = np.zeros((batch, w), np.uint32)
        d_starts = np.full((batch,), 3, np.int32)
        d_lit = np.empty((batch, lit_ls.shape[1]), np.int32)
        d_dist = np.empty((batch, C.MAX_DIST_SYMBOLS), np.int32)
        # padding rows decode an empty final fixed block ("\x03\x00")
        d_lit[:] = fixed_l
        d_dist[:] = 5
        words[:, 0] = 0x0003
        for k, i in enumerate(group):
            ref = refs[i]
            body = data[ref.body:ref.end - 8]
            arr = np.frombuffer(body + b"\x00" * ((-len(body)) % 4),
                                np.uint8)
            words[k] = 0
            words[k, :len(arr) // 4] = arr.view("<u4")
            d_starts[k] = starts[i]
            d_lit[k] = lit_ls[i]
            d_dist[k] = dist_ls[i]

        lit_t, dist_t = tables_from_lengths(jnp.asarray(d_lit),
                                            jnp.asarray(d_dist))
        a, b, nt, end_bit, err = decode_symbols_chunked(
            jnp.asarray(words), jnp.asarray(d_starts), lit_t, dist_t,
            out_cap + 2)
        db = len(group)
        err_np = np.asarray(err)
        if err_np[:db].any():
            bad = group[int(np.argmax(err_np[:db]))]
            raise DeflateError(f"invalid Huffman code in member {bad}")
        out, n_out, xerr = expand_tokens(a, b, nt, out_cap)
        xerr_np = np.asarray(xerr)
        if xerr_np[:db].any():
            bad = group[int(np.argmax(xerr_np[:db]))]
            raise DeflateError(f"bad back-reference in member {bad}")
        out_np = np.asarray(out)
        n_out_np = np.asarray(n_out)
        for k, i in enumerate(group):
            if int(n_out_np[k]) != int(isizes[i]):
                raise GzipError(
                    f"gzip ISIZE mismatch in member {i}: "
                    f"{int(isizes[i])} != {int(n_out_np[k])}")
        if verify:
            right = np.zeros_like(out_np)
            for k in range(db):
                ln = int(n_out_np[k])
                if ln:
                    right[k, out_cap - ln:] = out_np[k, :ln]
            crcs = crc32_batch_jax(jnp.asarray(right), n_out_np)
            for k, i in enumerate(group):
                if int(crcs[k]) != int(crcs_expected[i]):
                    raise GzipError(
                        f"gzip CRC mismatch in member {i}: stream says "
                        f"{int(crcs_expected[i]):#010x}, computed "
                        f"{int(crcs[k]):#010x}")
        for k, i in enumerate(group):
            pieces[i] = out_np[k, :int(n_out_np[k])].tobytes()

    if verify and host_members:
        from ..utils.checksum import crc32 as host_crc32
        eng_crc = native.crc32 if native.available() else host_crc32
        for i, piece in host_members.items():
            if eng_crc(piece) != int(crcs_expected[i]):
                raise GzipError(f"gzip CRC mismatch in member {i}")

    return b"".join(pieces)  # type: ignore[arg-type]
