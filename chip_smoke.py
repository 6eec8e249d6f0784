#!/usr/bin/env python
"""Chip smoke test: the PGZF main path on one GPU, end to end.

Phases (any failure exits non-zero before the result line):

1. device: JAX must find a GPU, and the native engine must load;
   prints the device, JAX version, XLA_FLAGS and the card's
   ``nvidia-smi`` name and power limit.
2. compile: the device encode batch and the decode-to-device chain at
   the corpus's real shapes, with ``compiled.memory_analysis()``.
3. stages vs their plain references at real widths, exact: the sync
   decode kernel against its XLA scan twin and the native token
   decode; the device expansion against ``native.expand_batch``; the
   device CRC against ``zlib.crc32``.
4. main path on the corpus (``--mb`` MiB of bench.make_corpus text from
   ``--seed``, 64 KiB members): ``pgzf.compress(engine="tpu")`` read
   back member by member by stdlib ``gzip.decompress``;
   ``pgzf.decompress(engine="tpu")``;
   ``pgzf.decompress_to_device(verify=True)``; and a stdlib-gzip stream
   through ``decompress_to_device(verify=True)``.  Wall times end in
   ``block_until_ready`` and are informational.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

``--four`` runs only the four-card path instead: the sharded sync
encode and decode and the decode-to-device chain ``shard_map``ped over
a 4-device mesh, each compared exactly with the one-card result.

Usage: python chip_smoke.py [--mb 256] [--seed 0] [--four]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np


def log(msg: str) -> None:
    print(f"[smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"ok: {what}")


def wall(fn):
    """(result, seconds) for fn, which must block on its result."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_device(four: bool):
    import jax

    from bench import card_info, setup_compile_cache
    from libflate_tpu import native

    cache = setup_compile_cache()
    devs = jax.devices()
    card = card_info()
    log(f"jax {jax.__version__}; devices {devs}; compile cache {cache}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(card, flush=True)
    check(devs[0].platform == "gpu", f"JAX platform is gpu "
          f"({devs[0].platform})")
    check(len(devs) >= (4 if four else 1), f"{len(devs)} device(s)")
    check(native.available(), "native engine loads")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    return info, card


def memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    return (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, out "
            f"{m.output_size_in_bytes / 2**20:.1f} MiB, temp "
            f"{m.temp_size_in_bytes / 2**20:.1f} MiB")


def one_card(args, card: str) -> None:
    import jax
    import jax.numpy as jnp

    from bench import (MEMBER, foreign_stream, make_corpus, rows_equal,
                       stdlib_gunzip)
    from libflate_tpu import native
    from libflate_tpu.formats import pgzf
    from libflate_tpu.ops import sync_decode as sd
    from libflate_tpu.ops.checksum import crc32_f_rows, crc32_from_padded_f
    from libflate_tpu.ops.device_expand import expand_members
    from libflate_tpu.ops.pipeline import _encode_batch_sync_packed

    label = f"[{card}]"
    data, t = wall(lambda: make_corpus(args.mb, args.seed))
    log(f"corpus: {len(data)} bytes from seed {args.seed} in {t:.1f} s")
    n_members = -(-len(data) // MEMBER)

    # ---- phase 2: compile at the real widths ---------------------------
    shape = jax.ShapeDtypeStruct((pgzf.DEV_BATCH, MEMBER), jnp.uint8)
    nv = jax.ShapeDtypeStruct((pgzf.DEV_BATCH,), jnp.int32)
    enc, t = wall(lambda: _encode_batch_sync_packed.lower(
        shape, nv, sd.SYNC_TOKENS).compile())
    log(f"compiled encode batch ({pgzf.DEV_BATCH} x {MEMBER} B) in "
        f"{t:.1f} s: {memory(enc)}")

    stream, t_enc_cold = wall(lambda: pgzf.compress(data, engine="tpu"))
    log(f"device encode (first call): {t_enc_cold:.2f} s")
    refs = pgzf.index_members(stream)
    check(len(refs) == n_members, f"{n_members} members")
    plan = pgzf._sync_plan(stream, refs)
    check(plan is not None and plan.device_ok.all(),
          "every member takes the sync device decode")
    members = np.arange(n_members)
    (idx, n_pad), = list(pgzf._member_batches(plan, members))
    ch_args, lo, hi = pgzf._chunk_args(plan, idx, n_pad)
    lit_t, dist_t = sd.decode_tables(plan.lit_lengths, plan.dist_lengths,
                                     plan.root_bits)
    words = jnp.asarray(plan.words)
    ch_args = [jnp.asarray(a) for a in ch_args]
    nt = jnp.asarray(plan.n_tokens)
    statics = dict(k_tok=plan.k_tok, root_bits=plan.root_bits,
                   max_nc=plan.chunk_word.shape[1],
                   member_cap=plan.member_cap, expand=True)
    chain, t = wall(lambda: pgzf._sync_chain().lower(
        words, *ch_args, lit_t, dist_t, jnp.asarray(lo), jnp.asarray(hi),
        nt, **statics).compile())
    log(f"compiled decode chain ({n_members} members, "
        f"{len(ch_args[0])} chunks) in {t:.1f} s: {memory(chain)}")

    # ---- phase 3: each stage against its plain reference ---------------
    tk, ek = jax.block_until_ready(sd.sync_decode(
        words, *ch_args, lit_t, dist_t, k_tokens=plan.k_tok,
        root_bits=plan.root_bits))
    tx, ex = jax.block_until_ready(sd.sync_decode_xla(
        words, *ch_args, lit_t, dist_t, k_tokens=plan.k_tok,
        root_bits=plan.root_bits))
    check(bool(jnp.array_equal(tk, tx)) and bool(jnp.array_equal(ek, ex)),
          f"sync decode kernel == XLA scan twin ({tk.size} token slots)")
    s = n_members * plan.chunk_word.shape[1]
    packed = jnp.transpose(tk)[:s].reshape(n_members, -1)
    ntoks, ncount, _ = native.inflate_tokens_batch(
        stream, [r.body for r in refs], [r.end - 8 for r in refs],
        packed.shape[1])
    pk = np.asarray(packed)
    check((ncount == plan.n_tokens).all()
          and all((pk[i, :n] == ntoks[i, :n]).all()
                  for i, n in enumerate(ncount)),
          "sync decode tokens == native token decode")
    plain, n_out, xerr = jax.block_until_ready(
        expand_members(packed, nt, plan.member_cap))
    blob, ncrcs = native.expand_batch(ntoks, None, ncount, plan.isizes)
    check(not bool(xerr.any()) and rows_equal(plain, n_out, blob),
          "device expansion == native.expand_batch")
    crcs = crc32_from_padded_f(np.asarray(crc32_f_rows(plain)),
                               plan.isizes, plan.member_cap)
    want = [zlib.crc32(data[i * MEMBER:(i + 1) * MEMBER])
            for i in range(n_members)]
    check(crcs.tolist() == want and ncrcs.tolist() == want,
          "device CRC == zlib.crc32 for every member")
    del tk, tx, ek, ex, packed, plain, n_out, xerr

    # ---- phase 4: the main path ----------------------------------------
    stream2, t_enc = wall(lambda: pgzf.compress(data, engine="tpu"))
    check(stream2 == stream, "device encode is deterministic")
    check(stdlib_gunzip(stream, refs) == data,
          "stdlib gzip.decompress decodes every member of the device "
          "encode")
    ratio = len(stream) / len(data)
    log(f"compressed ratio {ratio:.4f} ({len(stream)} / {len(data)} B)")

    out, t_dec = wall(lambda: pgzf.decompress(stream, engine="tpu"))
    check(out == data, 'pgzf.decompress(engine="tpu") returns the corpus')
    log(f"members decoded on the host (stored fallback): "
        f"{pgzf.host_members(stream)}")

    def to_device(st):
        return jax.block_until_ready(
            pgzf.decompress_to_device(st, verify=True))

    (rows, lens), t_dev = wall(lambda: to_device(stream))
    check(rows_equal(rows, lens, data),
          "decompress_to_device rows == corpus members (verify=True)")
    del rows, lens
    foreign, t = wall(lambda: foreign_stream(data))
    log(f"stdlib gzip stream (level 6, per 64 KiB member): "
        f"{len(foreign)} B in {t:.1f} s")
    (rows, lens), t_for = wall(lambda: to_device(foreign))
    check(rows_equal(rows, lens, data),
          "stdlib-gzip stream decodes to the device (verify=True)")
    mib = len(data) / 2**20
    for what, sec in (("device encode", t_enc),
                      ("decompress(engine=tpu)", t_dec),
                      ("decompress_to_device", t_dev),
                      ("foreign decompress_to_device", t_for)):
        log(f"{label} wall {what}: {sec:.3f} s ({mib / sec:.1f} MiB/s), "
            f"informational")


def four_cards(args) -> None:
    import jax
    import jax.numpy as jnp

    from bench import MEMBER, make_corpus, rows_equal
    from libflate_tpu.formats import pgzf
    from libflate_tpu.ops import sync_decode as sd
    from libflate_tpu.ops.deflate_encode import splice_blocks_host
    from libflate_tpu.ops.pipeline import _encode_batch_sync
    from libflate_tpu.parallel.mesh import make_mesh
    from libflate_tpu.parallel.sharding import (
        decode_sync_sharded, decompress_to_device_sharded,
        encode_sync_sharded)

    mesh = make_mesh(4)
    data = make_corpus(args.mb, args.seed)
    n_members = len(data) // MEMBER
    b = pgzf.DEV_BATCH
    blocks = np.frombuffer(data[:b * MEMBER], np.uint8).reshape(b, MEMBER)
    n_valid = np.full((b,), MEMBER, np.int32)
    k = sd.SYNC_TOKENS

    # sharded shared-table sync encode vs one card
    sharded = encode_sync_sharded(blocks, n_valid, np.ones(b, np.int32), k,
                                  mesh)
    one = [np.asarray(x) for x in _encode_batch_sync(
        jnp.asarray(blocks), jnp.asarray(n_valid), k)]
    check(all(np.array_equal(x, y) for x, y in zip(sharded, one)),
          f"encode_sync_sharded == one card ({b} members, 4 devices)")

    # sharded chunk-parallel sync decode vs the one-card kernel
    words, bits, cnt, offs = one
    bodies = [splice_blocks_host(words[i:i + 1], bits[i:i + 1])
              for i in range(b)]
    w = max(len(x) for x in bodies) // 4 + 2
    nc = -(-cnt // k)
    c_rows, c_bits, c_cnt, blob = [], [], [], bytearray()
    for i in range(b):
        arr = np.zeros(w, np.uint32)
        raw = np.frombuffer(bodies[i].ljust(4 * w, b"\0"), "<u4")
        arr[:] = raw[:w]
        for j in range(int(nc[i])):
            c_rows.append(arr)
            c_bits.append(int(offs[i, j]))
            c_cnt.append(min(k, int(cnt[i]) - j * k))
    lit_l, dist_l = _shared_lengths(bodies[0])
    toks = decode_sync_sharded(np.stack(c_rows), np.asarray(c_bits),
                               np.asarray(c_cnt), lit_l, dist_l, k, mesh)
    flat = np.concatenate([np.asarray(r) for r in c_rows])
    s_n = len(c_rows)
    s_pad = -(-s_n // sd.BLOCK) * sd.BLOCK
    cw = np.zeros(s_pad, np.int32)
    cw[:s_n] = np.arange(s_n) * w + (np.asarray(c_bits) >> 5)
    cb = np.zeros(s_pad, np.int32)
    cb[:s_n] = np.asarray(c_bits) & 31
    cc = np.zeros(s_pad, np.int32)
    cc[:s_n] = c_cnt
    rb = max(int(lit_l.max()), 7)
    lit_t, dist_t = sd.decode_tables(lit_l, dist_l, rb)
    ref, _ = sd.sync_decode(
        jnp.asarray(np.concatenate([flat, np.zeros(3, np.uint32)])),
        jnp.asarray(cw), jnp.asarray(cb), jnp.asarray(cc),
        jnp.zeros((s_pad,), jnp.int32), lit_t, dist_t, k_tokens=k,
        root_bits=rb)
    check(np.array_equal(toks, np.asarray(ref).T[:s_n]),
          f"decode_sync_sharded == one-card kernel ({s_n} chunks)")

    # the decode-to-device chain shard_mapped over the mesh vs one card
    stream = pgzf.compress(data[:n_members * MEMBER], engine="tpu")
    rows1, lens1 = jax.block_until_ready(
        pgzf.decompress_to_device(stream, verify=True))
    (rows4, lens4), t4 = wall(lambda: jax.block_until_ready(
        decompress_to_device_sharded(stream, mesh, verify=True)))
    check(np.array_equal(np.asarray(lens4), np.asarray(lens1))
          and bool(jnp.array_equal(jax.device_put(rows4, rows1.sharding),
                                   rows1))
          and rows_equal(rows4, lens4, data[:n_members * MEMBER]),
          f"decompress_to_device_sharded == one card ({n_members} "
          f"members, 4 devices)")
    log(f"4-device decode-to-device wall {t4:.3f} s (informational)")


def _shared_lengths(body: bytes):
    """(1, 286) / (1, 30) code lengths of a shared-table member body."""
    from libflate_tpu.serial.bitio import BitReader
    from libflate_tpu.serial.deflate import read_dynamic_header_lengths

    r = BitReader(body)
    r.read_bits(3)
    lit, dist = read_dynamic_header_lengths(r)
    return np.asarray(lit)[None, :286], np.asarray(dist)[None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=None,
                    help="corpus MiB (default 256; 64 with --four)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args()
    if args.mb is None:
        args.mb = 64 if args.four else 256
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    info, card = phase_device(args.four)
    if args.four:
        four_cards(args)
    else:
        one_card(args, card)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
