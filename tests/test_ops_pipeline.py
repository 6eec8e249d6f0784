"""Device encode/decode pipeline tests (CPU-backed JAX)."""
import gzip as pygzip
import zlib as pyzlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from libflate_tpu.ops.bitpack import pack_fields, words_to_bytes
from libflate_tpu.ops.deflate_decode import inflate_device
from libflate_tpu.ops.pipeline import deflate_device
from libflate_tpu.serial.bitio import BitWriter
from libflate_tpu.serial.deflate import EncodeOptions, deflate


class TestBitpack:
    def test_matches_bitwriter(self):
        rng = np.random.default_rng(0)
        vals = rng.integers(0, 1 << 20, 200).astype(np.int32)
        widths = rng.integers(0, 29, 200).astype(np.int32)
        w = BitWriter()
        for v, n in zip(vals, widths):
            w.write_bits(int(v), int(n))
        ref = w.getvalue()
        words, total = pack_fields(jnp.asarray(vals), jnp.asarray(widths))
        got = bytes(np.asarray(words_to_bytes(words))[:(int(total) + 7) // 8])
        assert got == ref

    def test_empty_and_zero_width(self):
        words, total = pack_fields(jnp.asarray([5, 7], jnp.int32),
                                   jnp.asarray([0, 0], jnp.int32))
        assert int(total) == 0


class TestDeviceEncode:
    BS = 4096      # small device blocks: keeps XLA CPU compiles fast

    def test_oracle_decodes_device_output(self, corpus):
        for data in corpus:
            enc = deflate_device(data, device_block_size=self.BS)
            d = pyzlib.decompressobj(-15)
            assert d.decompress(enc) == data

    def test_multi_block(self):
        rng = np.random.default_rng(2)
        data = bytes(rng.integers(0, 64, 40_000, dtype=np.uint8))
        enc = deflate_device(data, device_block_size=self.BS)
        d = pyzlib.decompressobj(-15)
        assert d.decompress(enc) == data

    def test_size_competitive_with_serial(self):
        data = (b"The quick brown fox jumps over the lazy dog. " * 500)
        enc = deflate_device(data, device_block_size=16384)
        ser = deflate(data, EncodeOptions(block_size=16384))
        assert len(enc) <= len(ser) * 1.05 + 64


class TestDeviceDecode:
    @pytest.mark.parametrize("bt,m", [("dynamic", "greedy"),
                                      ("fixed", "greedy"),
                                      ("stored", "none")])
    def test_own_streams(self, bt, m):
        rng = np.random.default_rng(3)
        for data in (b"", b"Hello World!",
                     bytes(rng.integers(0, 9, 3000, dtype=np.uint8))):
            enc = deflate(data, EncodeOptions(block_type=bt, matcher=m,
                                              block_size=1024))
            out = bytes(inflate_device(enc, out_cap=8192).data)
            assert out == data

    def test_foreign_streams(self):
        rng = np.random.default_rng(4)
        data = bytes(rng.integers(0, 30, 5000, dtype=np.uint8))
        for level in (1, 9):
            c = pyzlib.compressobj(level, pyzlib.DEFLATED, -15)
            enc = c.compress(data) + c.flush()
            assert bytes(inflate_device(enc, out_cap=8192).data) == data

    def test_cross_block_history(self):
        # matches reaching into the previous block
        data = b"0123456789abcdef" * 400          # 6.4 KB, highly repetitive
        c = pyzlib.compressobj(9, pyzlib.DEFLATED, -15)
        enc = c.compress(data) + c.flush()
        assert bytes(inflate_device(enc, out_cap=8192).data) == data


class TestPgzf:
    def test_roundtrip_and_gzip_compat(self):
        from libflate_tpu.formats import pgzf
        rng = np.random.default_rng(5)
        for data in (b"", b"small",
                     bytes(rng.integers(0, 7, 24_000, dtype=np.uint8))):
            z = pgzf.compress(data, member_size=8192)
            assert pygzip.decompress(z) == data
            assert pgzf.decompress(z) == data

    def test_fallback_plain_gzip(self):
        from libflate_tpu.formats import pgzf
        data = b"plain gzip payload " * 100
        assert pgzf.decompress(pygzip.compress(data)) == data

    def test_corrupt_member_detected(self):
        from libflate_tpu.formats import pgzf
        data = bytes(np.random.default_rng(6).integers(
            0, 256, 20_000, dtype=np.uint8))
        z = bytearray(pgzf.compress(data, member_size=8192))
        z[-10] ^= 0x01          # corrupt last member's trailer CRC region
        with pytest.raises(Exception):
            pgzf.decompress(bytes(z))
