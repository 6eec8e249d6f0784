"""Sync-indexed PGZF mode: LS subfield + zero-speculation device decode.

On the CPU the sync decode kernel runs in the Pallas interpreter; the
compiled kernel is exercised on the GPU by chip_smoke.py.
"""
import gzip as stdgzip
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from libflate_tpu.formats import pgzf


def _corpus(n, seed=7):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(400)]
    return b"\n".join(words[int(i)] for i in
                      rng.zipf(1.4, n // 3) % 400)[:n]


class TestSyncKernel:
    def test_tokens_match_tokenizer(self):
        """Kernel tokens == the device tokenizer's, chunk by chunk."""
        from libflate_tpu.ops import sync_decode as sd
        from libflate_tpu.ops.deflate_encode import splice_blocks_host
        from libflate_tpu.ops.pipeline import (_encode_batch_sync,
                                               _shared_stats, _tokenize)
        K = 32
        B = 4
        member = 2048
        data = _corpus(B * member)
        blocks = np.zeros((B, member), np.uint8)
        n_valid = np.zeros((B,), np.int32)
        for i in range(B):
            chunk = data[i * member:(i + 1) * member]
            blocks[i, :len(chunk)] = np.frombuffer(chunk, np.uint8)
            n_valid[i] = len(chunk)

        words, bits, cnt, offs = map(np.asarray, _encode_batch_sync(
            jnp.asarray(blocks), jnp.asarray(n_valid), K))
        a, b, _ = map(np.asarray, _tokenize(
            jnp.asarray(blocks), jnp.asarray(n_valid)))
        valid = (np.arange(a.shape[1], dtype=np.int32)[None, :]
                 < cnt[:, None])
        # must match _encode_batch_sync's table build (SHARED_MAX_LEN);
        # a 12-bit root over <=10-bit codes also covers the widest
        # root_bits decode path
        lit_l, dist_l, *_r = _shared_stats(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid))
        lit_t, dist_t = sd.decode_tables(np.asarray(lit_l)[None],
                                         np.asarray(dist_l)[None], 12)

        starts, counts, spans = [], [], []
        blob = bytearray()
        for i in range(B):
            base = len(blob) * 8
            blob += splice_blocks_host(words[i:i + 1], bits[i:i + 1])
            nc = -(-int(cnt[i]) // K)
            for j in range(nc):
                starts.append(base + int(offs[i, j]))
                counts.append(min(K, int(cnt[i]) - j * K))
            spans.append((i, nc))
        s_n = len(starts)
        s_pad = -(-s_n // sd.BLOCK) * sd.BLOCK
        ab = np.zeros(s_pad, np.int64)
        ab[:s_n] = starts
        cn = np.zeros(s_pad, np.int32)
        cn[:s_n] = counts
        toks, _end = sd.sync_decode(
            jnp.asarray(sd.stream_words(bytes(blob))),
            jnp.asarray((ab >> 5).astype(np.int32)),
            jnp.asarray((ab & 31).astype(np.int32)), jnp.asarray(cn),
            jnp.zeros((s_pad,), jnp.int32), lit_t, dist_t, k_tokens=K)
        toks = np.asarray(toks).T

        s = 0
        for i, nc in spans:
            flat = toks[s:s + nc].reshape(-1)[:int(cnt[i])]
            np.testing.assert_array_equal(flat & 511, a[i, :int(cnt[i])])
            np.testing.assert_array_equal(flat >> 9, b[i, :int(cnt[i])])
            s += nc


class TestSyncContainer:
    def test_roundtrip_and_stock_gzip(self):
        data = _corpus(200000) + bytes(
            np.random.default_rng(1).integers(0, 256, 40000,
                                              dtype=np.uint8))
        stream = pgzf.compress(data, member_size=32768, engine="tpu")
        # 100% stock-gzip readable (LS rides the standard FEXTRA)
        assert stdgzip.decompress(stream) == data
        # sync path decodes
        refs = pgzf.index_members(stream)
        plan = pgzf._sync_plan(stream, refs)
        assert pgzf._decompress_sync_device(stream, refs, plan, True) \
            == data
        # dispatcher routes to it
        assert pgzf.decompress(stream, engine="tpu") == data
        # other engines also decode it
        assert pgzf.decompress(stream, engine="native") == data

    @pytest.mark.parametrize("member_size", [3072, 24576])
    def test_non_pow2_member_size_crc(self, member_size):
        """Round-2 ADVICE regression: crc32_f_rows with a member size
        whose 64-byte chunk count is not a power of two wrote corrupt
        gzip CRC32 fields on the device engine."""
        data = _corpus(member_size * 3 + 1234)
        stream = pgzf.compress(data, member_size=member_size, engine="tpu")
        assert stdgzip.decompress(stream) == data          # CRCs verify
        assert pgzf.decompress(stream, verify=True) == data

    def test_ls_subfield_parse(self):
        data = _corpus(100000)
        stream = pgzf.compress(data, member_size=32768, engine="tpu")
        from libflate_tpu.formats import gzip as fgzip
        hdr, _ = fgzip.Header.decode(stream, 0)
        info = pgzf._parse_sync(hdr)
        assert info is not None
        k, n_tokens, first_bit, n_chunks, deltas = info
        assert k == 256 and n_tokens > 0
        assert n_chunks == -(-n_tokens // k)
        assert len(deltas) == n_chunks - 1
        assert (np.asarray(deltas) > 0).all()

    def test_corrupt_sync_index_falls_back_or_raises(self):
        data = _corpus(100000)
        stream = bytearray(pgzf.compress(data, member_size=32768,
                                         engine="tpu"))
        # flip a delta byte inside the first LS subfield: CRC must catch
        from libflate_tpu.formats import gzip as fgzip
        hdr, body = fgzip.Header.decode(bytes(stream), 0)
        # LS payload sits right before body: locate by id scan
        ls_pos = bytes(stream).find(b"LS", 0, body)
        assert ls_pos > 0
        stream[ls_pos + 2 + 2 + 14] ^= 0x40
        with pytest.raises(Exception):
            out = pgzf.decompress(bytes(stream), engine="tpu")
            assert out != data  # pragma: no cover - must raise above

    def test_native_stream_without_ls_falls_back(self):
        native = pytest.importorskip("libflate_tpu.native")
        if not native.available():
            pytest.skip("native engine unavailable")
        data = _corpus(100000)
        stream = pgzf.compress(data, member_size=32768, engine="native")
        refs = pgzf.index_members(stream)
        assert pgzf._sync_plan(stream, refs) is None
        assert pgzf.decompress(stream, engine="tpu") == data


class TestKernelDebugChecks:
    def test_poison_on_corrupt_index(self):
        """SURVEY §5 debug_assert parity: every chunk's final cursor is
        checked against the next chunk's LS offset, so a corrupt index
        raises a typed error instead of relying on the CRC."""
        from libflate_tpu.serial.deflate import DeflateError
        data = _corpus(120000)
        stream = bytearray(pgzf.compress(data, member_size=32768,
                                         engine="tpu"))
        assert pgzf.decompress(bytes(stream), engine="tpu",
                               verify=False) == data
        # corrupt a mid-stream LS delta so a chunk starts far off
        ls = bytes(stream).find(b"LS")
        assert ls > 0
        stream[ls + 4 + 15] ^= 0xFF
        with pytest.raises(DeflateError):
            pgzf.decompress(bytes(stream), engine="tpu", verify=False)
        with pytest.raises(DeflateError):
            pgzf.decompress_to_device(bytes(stream))


class TestDecompressToDevice:
    def test_plaintext_stays_on_device(self):
        """decompress_to_device: sync kernel -> device token reorder ->
        on-device LZ77 expansion; plaintext rows verified against the
        source without any engine-level D2H in between."""
        import jax.numpy as jnp
        data = _corpus(150000)
        stream = pgzf.compress(data, member_size=32768, engine="tpu")
        out, lengths = pgzf.decompress_to_device(stream, verify=True)
        assert isinstance(out, jnp.ndarray) and out.dtype == jnp.uint8
        pieces = []
        out_np = np.asarray(out)
        for i, ln in enumerate(np.asarray(lengths)):
            pieces.append(out_np[i, :int(ln)].tobytes())
        assert b"".join(pieces) == data

    def test_non_indexed_stream_takes_foreign_bridge(self):
        # round 5: streams without the LS sync index no longer reject —
        # they fall through to the foreign C-token bridge
        # (pgzf._foreign_to_device) and still land device-resident
        native = pytest.importorskip("libflate_tpu.native")
        if not native.available():
            pytest.skip("native engine unavailable")
        data = _corpus(80000)
        stream = pgzf.compress(data, member_size=32768, engine="native")
        out, lengths = pgzf.decompress_to_device(stream, verify=True)
        out_np = np.asarray(out)
        pieces = [out_np[i, :int(ln)].tobytes()
                  for i, ln in enumerate(np.asarray(lengths))]
        assert b"".join(pieces) == data


@pytest.mark.parametrize("seed", range(4))
def test_sync_container_content_fuzz(seed):
    """Randomized payload mixes through device encode -> every decoder."""
    rng = np.random.default_rng(100 + seed)
    parts = []
    for _ in range(int(rng.integers(2, 5))):
        kind = int(rng.integers(0, 4))
        n = int(rng.integers(1, 60000))
        if kind == 0:
            parts.append(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
        elif kind == 1:
            parts.append(bytes([int(rng.integers(0, 4))]) * n)
        elif kind == 2:
            parts.append(_corpus(n, seed=seed))
        else:
            piece = bytes(rng.integers(0, 64, max(n // 4, 1),
                                       dtype=np.uint8))
            parts.append((piece * 5)[:n])
    data = b"".join(parts)
    stream = pgzf.compress(data, member_size=32768, engine="tpu")
    assert stdgzip.decompress(stream) == data
    assert pgzf.decompress(stream, engine="tpu") == data
    assert pgzf.decompress(stream, engine="native") == data
