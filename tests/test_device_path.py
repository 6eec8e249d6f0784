"""The device path's stages against their plain references, on the CPU.

The sync decode kernel runs in the Pallas interpreter here (the same
kernel body the GPU compiles); every other stage is plain XLA.  The
references are the XLA scan twin, the native engine, the serial
oracle, numpy and zlib.
"""
import gzip as stdgzip
import subprocess
import sys
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu import native  # noqa: E402
from libflate_tpu.formats import pgzf  # noqa: E402
from libflate_tpu.ops import device, sync_decode as sd  # noqa: E402
from libflate_tpu.spec import constants as C  # noqa: E402


def _text(n, seed=7):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(400)]
    return b"\n".join(words[int(i)] for i in
                      rng.zipf(1.4, n // 3) % 400)[:n]


# ---------------------------------------------------------------------------
# per-token arithmetic of the sync decoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("li", range(29))
def test_length_code_matches_rfc_table(li):
    base, nx = sd._length_code(jnp.int32(li))
    assert (int(base), int(nx)) == (int(C.LENGTH_BASE[li]),
                                    int(C.LENGTH_EXTRA[li]))


@pytest.mark.parametrize("d", range(30))
def test_dist_code_matches_rfc_table(d):
    base, nx = sd._dist_code(jnp.int32(d))
    assert (int(base), int(nx)) == (int(C.DIST_BASE[d]),
                                    int(C.DIST_EXTRA[d]))


@pytest.mark.parametrize("k,nbits", [(0, 13), (5, 8), (31, 5), (32, 13),
                                     (33, 8), (50, 13)])
def test_bits_window(k, nbits):
    rng = np.random.default_rng(k)
    lo, hi = (int(x) for x in rng.integers(0, 2 ** 32, 2, dtype=np.uint64))
    want = ((lo | (hi << 32)) >> k) & ((1 << nbits) - 1)
    got = sd._bits(jnp.uint32(lo), jnp.uint32(hi), jnp.int32(k), nbits)
    assert int(got) == want


# ---------------------------------------------------------------------------
# the sync decode kernel: interpreted kernel == XLA twin == native
# ---------------------------------------------------------------------------
def _chunks(stream):
    """LS chunk arrays (padded to BLOCK) + tables of a PGZF stream."""
    refs = pgzf.index_members(stream)
    plan = pgzf._sync_plan(stream, refs)
    assert plan is not None and plan.device_ok.all()
    n = len(refs)
    args, _lo, _hi = pgzf._chunk_args(plan, np.arange(n), n)
    return refs, plan, [jnp.asarray(a) for a in args]


@pytest.mark.parametrize("root_bits", [10, 12])
@pytest.mark.parametrize("size", [5000, 20000, 45000])
def test_sync_kernel_matches_xla_twin_and_native(root_bits, size):
    """Short last chunks (sizes not multiples of K tokens) and both
    root widths; the kernel's end cursors match the twin's too."""
    stream = pgzf.compress(_text(size, seed=size), member_size=16384,
                           engine="tpu")
    refs, plan, args = _chunks(stream)
    lit_t, dist_t = sd.decode_tables(plan.lit_lengths, plan.dist_lengths,
                                     root_bits)
    words = jnp.asarray(plan.words)
    tk, ek = sd.sync_decode(words, *args, lit_t, dist_t,
                            root_bits=root_bits)
    tx, ex = sd.sync_decode_xla(words, *args, lit_t, dist_t,
                                root_bits=root_bits)
    tk, tx = np.asarray(tk), np.asarray(tx)
    assert (tk == tx).all() and (np.asarray(ek) == np.asarray(ex)).all()

    toks, counts, _ = native.inflate_tokens_batch(
        stream, [r.body for r in refs], [r.end - 8 for r in refs], 1 << 16)
    max_nc = plan.chunk_word.shape[1]
    rows = tk.T[:len(refs) * max_nc].reshape(len(refs), -1)
    for i in range(len(refs)):
        n = int(counts[i])
        assert n == int(plan.n_tokens[i])
        assert (rows[i, :n] == toks[i, :n]).all(), i


def test_sync_decode_rejects_unaligned_chunk_count():
    with pytest.raises(ValueError):
        z = jnp.zeros((sd.BLOCK + 1,), jnp.int32)
        sd.sync_decode(jnp.zeros((8,), jnp.uint32), z, z, z, z,
                       jnp.zeros((1 << 12,), jnp.int32),
                       jnp.zeros((256,), jnp.int32))


# ---------------------------------------------------------------------------
# encode stages vs plain references
# ---------------------------------------------------------------------------
def _blocks(n_rows=4, n=4096, seed=0):
    data = _text(n_rows * n, seed)
    blocks = np.frombuffer(data.ljust(n_rows * n, b"q"),
                           np.uint8).reshape(n_rows, n).copy()
    return blocks, np.full((n_rows,), n, np.int32)


def test_shared_histogram_matches_numpy():
    from libflate_tpu.ops.deflate_encode import token_symbols
    from libflate_tpu.ops.pipeline import _tokenize
    from libflate_tpu.ops.deflate_encode import token_histograms_masked

    blocks, nv = _blocks()
    a, b, cnt = _tokenize(jnp.asarray(blocks), jnp.asarray(nv))
    valid = jnp.arange(a.shape[1])[None, :] < cnt[:, None]
    lit, dist = jax.vmap(token_histograms_masked)(a, b, valid)
    ls, ds, _m = map(np.asarray, jax.vmap(token_symbols)(a, b, valid))
    v = np.asarray(valid)
    for i in range(blocks.shape[0]):
        want_lit = np.bincount(ls[i][v[i]], minlength=286)
        want_lit[256] += 1
        want_dist = np.bincount(ds[i][v[i] & (ds[i] >= 0)], minlength=30)
        assert (np.asarray(lit[i]) == want_lit).all()
        assert (np.asarray(dist[i]) == want_dist).all()


def test_shared_fields_and_pack_decode_with_zlib():
    """Sort matcher -> parse -> shared table -> fields -> pack: every
    member is a raw DEFLATE stream zlib reads back."""
    from libflate_tpu.ops.deflate_encode import splice_blocks_host
    from libflate_tpu.ops.pipeline import _encode_batch

    blocks, nv = _blocks()
    nv[1] = 1000
    words, bits = map(np.asarray, _encode_batch(
        jnp.asarray(blocks), jnp.asarray(nv),
        jnp.ones((4,), jnp.int32), "shared"))
    for i in range(4):
        body = splice_blocks_host(words[i:i + 1], bits[i:i + 1])
        assert zlib.decompress(body, -15) == blocks[i, :nv[i]].tobytes()


def test_sync_offsets_point_at_token_boundaries():
    """LS offsets land where the native decoder's k-th token starts:
    decoding K tokens from each offset ends at the next offset."""
    stream = pgzf.compress(_text(60000), member_size=16384, engine="tpu")
    refs, plan, args = _chunks(stream)
    lit_t, dist_t = sd.decode_tables(plan.lit_lengths, plan.dist_lengths,
                                     plan.root_bits)
    _t, end = sd.sync_decode_xla(jnp.asarray(plan.words), *args, lit_t,
                                 dist_t, root_bits=plan.root_bits)
    s = plan.chunk_word.size
    end = np.asarray(end)[:s]
    assert ((end >= plan.lo.reshape(-1)) & (end <= plan.hi.reshape(-1))
            ).all()


# ---------------------------------------------------------------------------
# expansion with history, CRC
# ---------------------------------------------------------------------------
def test_expand_tokens_reaches_into_history():
    from libflate_tpu.ops.device_expand import expand_tokens
    from libflate_tpu.serial.lz77 import greedy_tokens

    hist = b"abcdefgh" * 8
    tail = hist + b"xyz" + hist[:40]
    toks = greedy_tokens(tail)
    # drop the tokens that cover the history: the rest reference it
    out_toks, pos = [], 0
    for a, b in toks:
        if pos >= len(hist):
            out_toks.append((a, b))
        pos += a if b else 1
    assert any(b > 0 for _, b in out_toks)
    a = np.array([[t[0] for t in out_toks]], np.int32)
    b = np.array([[t[1] for t in out_toks]], np.int32)
    h = np.zeros((1, 128), np.uint8)
    h[0, 128 - len(hist):] = np.frombuffer(hist, np.uint8)
    out, n_out, err = expand_tokens(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray([a.shape[1]], np.int32),
        1024, jnp.asarray(h), jnp.asarray([len(hist)], np.int32))
    assert not bool(err[0])
    assert np.asarray(out)[0, :int(n_out[0])].tobytes() == tail[len(hist):]


@pytest.mark.parametrize("n", [1, 63, 4096, 70001])
def test_crc32_f_rows_matches_zlib(n):
    from libflate_tpu.ops.checksum import crc32_f_rows, crc32_from_padded_f

    rng = np.random.default_rng(n)
    rows = rng.integers(0, 256, (3, n), dtype=np.uint8)
    lens = np.array([n, n // 2, 0])
    for i, ln in enumerate(lens):
        rows[i, ln:] = 0
    got = crc32_from_padded_f(np.asarray(crc32_f_rows(jnp.asarray(rows))),
                              lens, n)
    want = [zlib.crc32(rows[i, :ln].tobytes()) for i, ln in enumerate(lens)]
    assert got.tolist() == want


# ---------------------------------------------------------------------------
# routing and the no-fallback rule
# ---------------------------------------------------------------------------
def test_routing_on_cpu():
    assert device.backend() == "cpu"
    assert device.interpret() and not device.has_accelerator()


def test_routing_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert not device.interpret() and device.has_accelerator()


def _boom(*_a, **_k):
    raise RuntimeError("device failure")


@pytest.mark.parametrize("entry", ["compress", "decompress",
                                   "decompress_to_device"])
def test_explicit_device_engine_failure_raises(monkeypatch, entry):
    data = _text(40000)
    stream = pgzf.compress(data, member_size=16384, engine="tpu")
    monkeypatch.setattr(pgzf, "_compress_device", _boom)
    monkeypatch.setattr(pgzf, "_decompress_sync_device", _boom)
    monkeypatch.setattr(pgzf, "_sync_chain", _boom)
    with pytest.raises(RuntimeError, match="device failure"):
        if entry == "compress":
            pgzf.compress(data, member_size=16384, engine="tpu")
        elif entry == "decompress":
            pgzf.decompress(stream, engine="tpu")
        else:
            pgzf.decompress_to_device(stream)


def test_auto_engine_stays_on_host_without_accelerator(monkeypatch):
    data = _text(40000)
    stream = pgzf.compress(data, member_size=16384, engine="tpu")
    monkeypatch.setattr(pgzf, "_compress_device", _boom)
    monkeypatch.setattr(pgzf, "_decompress_sync_device", _boom)
    assert stdgzip.decompress(pgzf.compress(data, engine=None)) == data
    assert pgzf.decompress(stream, engine=None) == data


def test_unsupported_options_route_before_device(monkeypatch):
    """matcher="none" / stored blocks: an explicit check routes to the
    per-member host framing without entering the device encoder."""
    from libflate_tpu.serial.deflate import EncodeOptions

    monkeypatch.setattr(pgzf, "_compress_device", _boom)
    data = _text(20000)
    for opts in (EncodeOptions(matcher="none"),
                 EncodeOptions(block_type="stored")):
        z = pgzf.compress(data, member_size=8192, options=opts,
                          engine="tpu")
        assert stdgzip.decompress(z) == data


def test_no_tpu_module_imported():
    """Importing every libflate_tpu module loads no TPU Pallas API
    module (``jax.experimental.pallas`` submodules ``tpu*``), in a
    fresh interpreter: other tests share this one."""
    code = (
        "import importlib, pkgutil, sys, libflate_tpu\n"
        "for m in pkgutil.walk_packages(libflate_tpu.__path__,"
        " 'libflate_tpu.'):\n"
        "    if not m.name.startswith('libflate_tpu.native.libflate'):\n"
        "        importlib.import_module(m.name)\n"
        "pre = 'jax.experimental.pallas.'\n"
        "bad = [k for k in sys.modules if k.startswith(pre)"
        " and k[len(pre):].split('.')[0].startswith('tp')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={**__import__("os").environ,
                            "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
