#!/usr/bin/env python
"""Benchmark harness for the PGZF device path on a GPU.

Prints ONE JSON line.  Runs the main path on a synthetic titles-shaped
corpus: device encode (``pgzf.compress(engine="tpu")``), device symbol
decode + native expand (``pgzf.decompress(engine="tpu")``),
``pgzf.decompress_to_device`` on the device encoder's stream and on a
stdlib-gzip stream, and the native host engine beside them.  Every
device time ends in ``block_until_ready``; every pass is checked
byte-exact first.  It also times the sync decode kernel against its
XLA scan twin end to end through ``decompress_to_device``.  With
``--trace DIR`` it records ``jax.profiler`` traces of one encode batch
(8 MiB) and of one decode-to-device call on the corpus (with the
kernel, and with the XLA twin) and reduces each to device time per
stage (``stage_times``).

Fails (exit 1) when JAX finds no GPU.  Every result names the card
(``nvidia-smi`` name and power limit) and the JAX device.

Usage: python bench.py [--mb 64] [--seed 42] [--trace DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import pathlib
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

MEMBER = 64 * 1024
#: named scopes the device code puts around each stage (ops/pipeline,
#: formats/pgzf._sync_chain_body); stage_times sums device time by them
STAGES = ("lf_match", "lf_lengths", "lf_parse", "lf_huffman", "lf_fields",
          "lf_pack", "lf_offsets", "lf_crc", "lf_sync_decode", "lf_reorder",
          "lf_expand")


def make_corpus(mb: int, seed: int = 42) -> bytes:
    """Synthetic enwiki-titles-like corpus: newline-separated titles of
    one or two ``_``-joined words from a Zipfian vocabulary (mirrors the
    reference's 265 MB enwiki-latest-all-titles benchmark input,
    README.md:46-68).  Built vectorized, 16 MiB at a time."""
    rng = np.random.default_rng(seed)
    vocab_n, max_len = 60000, 11
    alphabet = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_0123456789",
        np.uint8)
    wlen = rng.integers(3, max_len + 1, vocab_n)
    table = rng.choice(alphabet, (vocab_n, max_len + 1))
    target = mb << 20
    out = bytearray()
    while len(out) < target:
        n_titles = 1 << 21
        two = rng.random(n_titles) < 0.5
        n_words = 1 + two
        ids = rng.zipf(1.3, int(n_words.sum())) % vocab_n
        # separator after each word: "_" inside a two-word title
        first_of_two = np.zeros(len(ids), bool)
        first_of_two[(np.cumsum(n_words) - n_words)[two]] = True
        tab = table[ids]
        lens = wlen[ids]
        tab[np.arange(len(ids)), lens] = np.where(first_of_two, ord("_"),
                                                  ord("\n"))
        keep = np.arange(max_len + 1)[None, :] <= lens[:, None]
        out += tab[keep].tobytes()
    return bytes(out[:target])


def card_info() -> str:
    """``nvidia-smi`` name and power limit of the card(s)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def setup_compile_cache() -> str:
    """JAX's persistent compile cache: JAX_COMPILATION_CACHE_DIR when
    set (JAX reads it itself), else .jax_cache/ in the checkout."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(pathlib.Path(__file__).resolve().parent / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The JAX device, or exit 1 when it is not a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX runs on {dev.platform}", file=sys.stderr)
        sys.exit(1)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def timed(fn, repeats: int = 3):
    """(last result, best wall seconds); fn must block on its result."""
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def foreign_stream(data: bytes, member: int = MEMBER) -> bytes:
    """stdlib gzip level 6, one member per ``member`` bytes."""
    with ThreadPoolExecutor() as ex:
        return b"".join(ex.map(lambda i: gzip.compress(data[i:i + member],
                                                       6),
                               range(0, len(data), member)))


def stdlib_gunzip(stream: bytes, refs) -> bytes:
    """stdlib ``gzip.decompress`` member by member (``refs`` from
    pgzf.index_members): the whole-stream call copies the remaining
    stream once per member, quadratic in the member count."""
    with ThreadPoolExecutor() as ex:
        return b"".join(ex.map(
            lambda r: gzip.decompress(stream[r.start:r.end]), refs))


def rows_equal(out, lengths, data: bytes) -> bool:
    """decompress_to_device rows == the corpus, member by member."""
    out, lengths = np.asarray(out), np.asarray(lengths)
    return b"".join(out[i, :n].tobytes()
                    for i, n in enumerate(lengths)) == data


def hlo_scopes(*compiled) -> dict:
    """(module, kernel name) -> STAGES scope, from compiled modules'
    HLO text.

    Every instruction's ``op_name`` metadata carries the named scopes
    it was traced under; a GPU kernel is named after its instruction
    with "." replaced by "_", and kernel names repeat across modules."""
    names = {}
    for c in compiled:
        text = c.as_text()
        module = re.match(r"HloModule (\S+?),?\s", text).group(1)
        for line in text.splitlines():
            m = re.match(r"\s*(?:ROOT )?%([\w.\-]+) = .*op_name=\"([^\"]*)",
                         line)
            if m:
                stage = next((s for s in STAGES if s in m.group(2)), None)
                if stage:
                    names[module, m.group(1).replace(".", "_")] = stage
    return names


def stage_times(trace_dir: str, names: dict) -> dict:
    """Device milliseconds per STAGES scope in a jax.profiler trace.

    Sums the durations of the GPU planes' kernel and copy events; a
    kernel maps to its stage through ``names`` (hlo_scopes, keyed by
    the event's ``hlo_module`` stat) or its own name, copies count as
    "memcpy", anything else as "other".
    """
    from jax.profiler import ProfileData
    files = sorted(pathlib.Path(trace_dir).rglob("*.xplane.pb"))
    if not files:
        return {}
    prof = ProfileData.from_file(str(files[-1]))
    ms: dict = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                module = dict(ev.stats).get("hlo_module", "")
                stage = names.get((module, ev.name)) or next(
                    (s for s in STAGES if s[3:] in ev.name),
                    "memcpy" if ev.name.startswith("Memcpy") else "other")
                ms[stage] = ms.get(stage, 0.0) + ev.duration_ns / 1e6
    return {k: round(v, 3) for k, v in sorted(ms.items())}


@contextlib.contextmanager
def xla_twin(pgzf, sd):
    """Run the decode chain with the XLA scan twin in place of the sync
    decode kernel (the chain imports ``sync_decode`` when it traces)."""
    kernel = sd.sync_decode
    sd.sync_decode = sd.sync_decode_xla
    pgzf._sync_chain.cache_clear()
    try:
        yield
    finally:
        sd.sync_decode = kernel
        pgzf._sync_chain.cache_clear()


def _chain_calls(pgzf, stream: bytes):
    """The (args, statics) of each _sync_chain call decompress_to_device
    makes for ``stream``."""
    import jax.numpy as jnp

    from libflate_tpu.ops.sync_decode import decode_tables
    refs = pgzf.index_members(stream)
    plan = pgzf._sync_plan(stream, refs)
    lit_t, dist_t = decode_tables(plan.lit_lengths, plan.dist_lengths,
                                  plan.root_bits)
    for idx, n_pad in pgzf._member_batches(plan, np.arange(len(refs))):
        ch, lo, hi = pgzf._chunk_args(plan, idx, n_pad)
        nt = np.zeros((n_pad,), np.int32)
        nt[:len(idx)] = plan.n_tokens[idx]
        yield ((jnp.asarray(plan.words), *map(jnp.asarray, ch), lit_t,
                dist_t, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(nt)),
               dict(k_tok=plan.k_tok, root_bits=plan.root_bits,
                    max_nc=plan.chunk_word.shape[1],
                    member_cap=plan.member_cap, expand=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import jax

    from libflate_tpu import native
    from libflate_tpu.formats import pgzf

    setup_compile_cache()
    dev = require_gpu()
    card = card_info()
    data = make_corpus(args.mb, args.seed)
    gb = len(data) / 1e9
    res = {"device": dev, "card": card, "corpus_mib": args.mb,
           "seed": args.seed, "xla_flags": os.environ.get("XLA_FLAGS", "")}

    stream = pgzf.compress(data, engine="tpu")            # compile + check
    assert stdlib_gunzip(stream, pgzf.index_members(stream)) == data, \
        "device encode mismatch"
    res["ratio"] = len(stream) / len(data)
    _, t = timed(lambda: pgzf.compress(data, engine="tpu"))
    res["device_encode_gbps"] = gb / t

    assert pgzf.decompress(stream, engine="tpu") == data
    _, t = timed(lambda: pgzf.decompress(stream, engine="tpu"))
    res["device_decode_gbps"] = gb / t

    def to_device(s):
        return jax.block_until_ready(pgzf.decompress_to_device(s))

    assert rows_equal(*to_device(stream), data)
    _, t = timed(lambda: to_device(stream))
    res["decode_to_device_gbps"] = gb / t
    _, t = timed(lambda: pgzf._sync_plan(stream, pgzf.index_members(stream)))
    res["decode_to_device_host_staging_s"] = t

    # the sync decode kernel against its XLA scan twin, end to end
    from libflate_tpu.ops import sync_decode as sd
    with xla_twin(pgzf, sd):
        assert rows_equal(*to_device(stream), data)
        _, t_twin = timed(lambda: to_device(stream))
    _, t_kern = timed(lambda: to_device(stream))
    res["decode_to_device_s"] = {"triton_kernel": t_kern,
                                 "xla_scan_twin": t_twin}

    foreign = foreign_stream(data)
    assert rows_equal(*to_device(foreign), data)
    _, t = timed(lambda: to_device(foreign))
    res["foreign_to_device_gbps"] = gb / t

    if native.available():
        _, t = timed(lambda: pgzf.compress(data, engine="native"))
        res["native_encode_gbps"] = gb / t
        nat = pgzf.compress(data, engine="native")
        res["native_ratio"] = len(nat) / len(data)
        _, t = timed(lambda: pgzf.decompress(nat, engine="native"))
        res["native_decode_gbps"] = gb / t

    if args.trace:
        # one encode batch and one decode-to-device call, warm
        from libflate_tpu.ops.pipeline import _encode_batch_sync_packed
        batch = np.frombuffer(data[:pgzf.DEV_BATCH * MEMBER], np.uint8)
        blocks = jax.numpy.asarray(batch.reshape(pgzf.DEV_BATCH, MEMBER))
        nv = jax.numpy.full((pgzf.DEV_BATCH,), MEMBER, jax.numpy.int32)
        enc = _encode_batch_sync_packed.lower(blocks, nv,
                                              sd.SYNC_TOKENS).compile()
        jax.block_until_ready(enc(blocks, nv))
        chain = pgzf._sync_chain()
        names = hlo_scopes(enc, *[
            chain.lower(*a, **kw).compile() for a, kw in _chain_calls(
                pgzf, stream)])
        with jax.profiler.trace(args.trace + "/encode"):
            jax.block_until_ready(enc(blocks, nv))
        with jax.profiler.trace(args.trace + "/decode"):
            to_device(stream)
        res["stage_device_ms"] = {
            "encode_batch": stage_times(args.trace + "/encode", names),
            "decode_to_device": stage_times(args.trace + "/decode", names)}
        with xla_twin(pgzf, sd):
            chain = pgzf._sync_chain()
            names = hlo_scopes(*[chain.lower(*a, **kw).compile()
                                 for a, kw in _chain_calls(pgzf, stream)])
            to_device(stream)
            with jax.profiler.trace(args.trace + "/decode_twin"):
                to_device(stream)
        res["stage_device_ms"]["decode_to_device_xla_twin"] = stage_times(
            args.trace + "/decode_twin", names)
        res["peak_bytes_in_use"] = (
            jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
