"""Sharded (multi-device) encode/decode over a jax.sharding.Mesh.

The codec pipelines in libflate_tpu.ops are written block-elementwise
over the leading batch axis, so multi-device execution is pure data
parallelism: annotate the block axis with a NamedSharding and jit — XLA
partitions every stage (sort, scan, scatter, matmul) per shard with no
cross-device traffic except the shared-table histogram's all-reduce
and the host-edge gather.  The sync decode kernel runs per device under
``shard_map``.  Checksums fold across shards with the exact CRC-combine
operator.

This replaces what a CPU library would do with threads — the reference
has no parallel path at all (SURVEY.md §2.3).

Example (virtual CPU devices work too — set
``XLA_FLAGS=--xla_force_host_platform_device_count=8``)::

    from libflate_tpu.parallel.mesh import make_mesh
    from libflate_tpu.parallel.sharding import (encode_sync_sharded,
                                                decompress_to_device_sharded)

    mesh = make_mesh(4)                    # 1-D "blocks" axis
    words, bits, counts, offsets = encode_sync_sharded(
        blocks, n_valid, bfinal, k=256, mesh=mesh)
    plain, lengths = decompress_to_device_sharded(stream, mesh)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops.deflate_decode import decode_symbols, tables_from_lengths
from ..ops.device_expand import expand_tokens
from ..ops.pipeline import _encode_batch
from ..utils.checksum import crc32_combine
from .mesh import BLOCK_AXIS, block_sharding, make_mesh


@functools.lru_cache(maxsize=8)
def _sharded_encode_fn(mesh_key, block_type: str):
    mesh = mesh_key
    sh = block_sharding(mesh)
    return jax.jit(
        functools.partial(_encode_batch, block_type=block_type),
        in_shardings=(sh, sh, sh),
        out_shardings=(sh, sh),
    )


def encode_blocks_sharded(blocks: np.ndarray, n_valid: np.ndarray,
                          bfinal: np.ndarray, mesh=None,
                          block_type: str = "dynamic"):
    """Data-parallel block encode across the mesh.

    blocks: (B, n) uint8 — B must be a multiple of the mesh size.
    Returns host numpy (words (B, W), bits (B,)).
    """
    mesh = mesh or make_mesh()
    fn = _sharded_encode_fn(mesh, block_type)
    sh = block_sharding(mesh)
    blocks_d = jax.device_put(jnp.asarray(blocks), sh)
    nv_d = jax.device_put(jnp.asarray(n_valid), sh)
    bf_d = jax.device_put(jnp.asarray(bfinal), sh)
    words, bits = fn(blocks_d, nv_d, bf_d)
    return np.asarray(words), np.asarray(bits)


def decode_members_sharded(words: np.ndarray, starts: np.ndarray,
                           lit_lengths: np.ndarray,
                           dist_lengths: np.ndarray,
                           out_cap: int, mesh=None):
    """Data-parallel member decode across the mesh.

    All inputs batched on the leading (member) axis, B divisible by the
    mesh size.  Returns (out (B, out_cap) uint8, n_out (B,), err (B,)).
    """
    mesh = mesh or make_mesh()
    sh = block_sharding(mesh)

    @functools.partial(jax.jit,
                       in_shardings=(sh, sh, sh, sh),
                       out_shardings=(sh, sh, sh),
                       static_argnums=(4,))
    def _run(w, s, ll, dl, cap):
        lit_t, dist_t = tables_from_lengths(ll, dl)
        a, b, nt, _end, err = decode_symbols(w, s, lit_t, dist_t, cap + 2)
        out, n_out, xerr = expand_tokens(a, b, nt, cap)
        return out, n_out, err | xerr

    out, n_out, err = _run(
        jax.device_put(jnp.asarray(words), sh),
        jax.device_put(jnp.asarray(starts), sh),
        jax.device_put(jnp.asarray(lit_lengths), sh),
        jax.device_put(jnp.asarray(dist_lengths), sh),
        out_cap)
    return np.asarray(out), np.asarray(n_out), np.asarray(err)


def encode_sync_sharded(blocks: np.ndarray, n_valid: np.ndarray,
                        bfinal: np.ndarray, k: int, mesh=None):
    """Flagship path, mesh-sharded: shared-table sync encode.

    The PGZF production pipeline — batch-global histograms (the
    per-shard sums cross shard boundaries, so XLA inserts all-reduce
    collectives over the mesh axis), one shared Huffman header per
    member, and the per-member sync offsets (the "LS" index the sync
    decoder consumes).  Every member is one final block, so ``bfinal``
    is not read.

    Returns host numpy (words (B, W) uint32, bits (B,), n_tokens (B,),
    offsets (B, S) int32).
    """
    from ..ops.pipeline import _encode_batch_sync
    del bfinal
    mesh = mesh or make_mesh()
    sh = block_sharding(mesh)

    @functools.partial(jax.jit, static_argnums=(2,),
                       in_shardings=(sh, sh),
                       out_shardings=(sh, sh, sh, sh))
    def _run(b, nv, kk):
        return _encode_batch_sync(b, nv, kk)

    words, bits, cnt, offsets = _run(
        jax.device_put(jnp.asarray(blocks), sh),
        jax.device_put(jnp.asarray(n_valid), sh), k)
    return (np.asarray(words), np.asarray(bits), np.asarray(cnt),
            np.asarray(offsets))


def decode_sync_sharded(words: np.ndarray, chunk_bits: np.ndarray,
                        chunk_counts: np.ndarray,
                        lit_lengths: np.ndarray, dist_lengths: np.ndarray,
                        k: int, mesh=None):
    """Chunk-parallel sync decode across the mesh (ops/sync_decode under
    ``shard_map``): every K-token chunk decodes independently from its
    LS bit offset, chunks split evenly over the devices.

    words: (C, W) uint32 per-chunk word views (chunk c's bits start at
    bit ``chunk_bits[c]`` of row c); chunk_counts: (C,) tokens per
    chunk (<= k); lit/dist lengths are the SHARED code set
    (1, 286)/(1, 30).

    Returns packed tokens (C, k) int32 (a | b<<9).
    """
    from ..ops import sync_decode as sd
    mesh = mesh or make_mesh()
    n_dev = mesh.size
    c_n, w = words.shape
    per = -(-max(c_n, 1) // n_dev)
    per = -(-per // sd.BLOCK) * sd.BLOCK

    def pad(x):
        out = np.zeros((n_dev * per,) + x.shape[1:], x.dtype)
        out[:c_n] = x
        return out

    rb = max(int(np.max(lit_lengths)), 7)
    lit_t, dist_t = sd.decode_tables(
        np.asarray(lit_lengths)[:, :286], np.asarray(dist_lengths), rb)

    def shard_fn(wd, cb, cnt):
        flat = jnp.concatenate([wd.reshape(-1),
                                jnp.zeros((sd.SLACK_WORDS,), jnp.uint32)])
        cw = jnp.arange(per, dtype=jnp.int32) * w + (cb >> 5)
        toks, _end = sd.sync_decode(flat, cw, cb & 31, cnt,
                                    jnp.zeros((per,), jnp.int32), lit_t,
                                    dist_t, k_tokens=k, root_bits=rb)
        return toks.T

    ax = P(BLOCK_AXIS)
    fn = jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=(ax, ax, ax),
                               out_specs=ax, check_vma=False))
    toks = fn(jnp.asarray(pad(np.asarray(words, np.uint32))),
              jnp.asarray(pad(np.asarray(chunk_bits, np.int32))),
              jnp.asarray(pad(np.asarray(chunk_counts, np.int32))))
    return np.asarray(toks)[:c_n]


def decompress_to_device_sharded(data: bytes, mesh=None,
                                 verify: bool = False):
    """``pgzf.decompress_to_device`` for a sync-indexed PGZF stream with
    its members split evenly over the mesh: each device runs the whole
    decode chain (sync decode, reorder, expansion, CRC) on its members
    under ``shard_map``; the compressed stream and code tables are
    replicated.  Returns (out (n_members, member_cap) uint8 sharded by
    member, lengths (n_members,) int32).
    """
    from ..formats import pgzf
    from ..formats.gzip import GzipError
    from ..ops.checksum import crc32_from_padded_f
    from ..ops.sync_decode import decode_tables
    from ..serial.deflate import DeflateError

    mesh = mesh or make_mesh()
    n_dev = mesh.size
    data = bytes(data)
    refs = pgzf.index_members(data)
    plan = pgzf._sync_plan(data, refs) if refs is not None else None
    if plan is None or not plan.device_ok.all():
        raise DeflateError("not a fully sync-indexed PGZF stream")
    n = len(refs)
    per = -(-n // n_dev)
    cols = [[] for _ in range(6)]
    nt = np.zeros((n_dev * per,), np.int32)
    for d in range(n_dev):
        idx = np.arange(d * per, min((d + 1) * per, n))
        args, lo, hi = pgzf._chunk_args(plan, idx, per)
        for c, x in zip(cols, args + [lo, hi]):
            c.append(x)
        nt[d * per:d * per + len(idx)] = plan.n_tokens[idx]
    cw, cb, cnt, tab, lo, hi = (jnp.asarray(np.concatenate(c))
                                for c in cols)
    lit_t, dist_t = decode_tables(plan.lit_lengths, plan.dist_lengths,
                                  plan.root_bits)

    def shard_fn(words, cw, cb, cnt, tab, lo, hi, nt):
        return pgzf._sync_chain_body(
            words, cw, cb, cnt, tab, lit_t, dist_t, lo, hi, nt,
            k_tok=plan.k_tok, root_bits=plan.root_bits,
            max_nc=plan.chunk_word.shape[1], member_cap=plan.member_cap,
            expand=True)

    ax = P(BLOCK_AXIS)
    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(),) + (ax,) * 7,
        out_specs=(ax, ax, ax), check_vma=False))
    plain, err, crc_f = fn(jnp.asarray(plan.words), cw, cb, cnt, tab, lo,
                           hi, jnp.asarray(nt))
    err = np.asarray(err)[:n]
    if err.any():
        raise DeflateError(f"device decode failed in member "
                           f"{int(np.argmax(err))}")
    if verify:
        crcs = crc32_from_padded_f(np.asarray(crc_f)[:n], plan.isizes,
                                   plan.member_cap)
        bad = crcs != plan.crcs_expected
        if bad.any():
            raise GzipError(f"gzip CRC mismatch in member "
                            f"{int(np.argmax(bad))}")
    return plain[:n], jnp.asarray(plan.isizes, jnp.int32)


def combine_shard_crcs(crcs: list[int], lengths: list[int]) -> int:
    """Fold ordered per-shard CRCs into the stream CRC (host edge)."""
    total = 0
    acc_len = 0
    for c, ln in zip(crcs, lengths):
        if acc_len == 0:
            total, acc_len = c, ln
        else:
            total = crc32_combine(total, c, ln)
            acc_len += ln
    return total
