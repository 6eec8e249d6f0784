"""Options-surface parity + threaded-native PGZF tests."""
import gzip as pygzip
import zlib as pyzlib

import numpy as np
import pytest

from libflate_tpu import native
from libflate_tpu.formats import gzip as fgzip, pgzf, zlib as fzlib


class TestGzipOptions:
    def test_levels_roundtrip(self):
        data = b"level test payload " * 200
        for level in (fgzip.CompressionLevel.NONE,
                      fgzip.CompressionLevel.FAST,
                      fgzip.CompressionLevel.BALANCE,
                      fgzip.CompressionLevel.BEST):
            opts = fgzip.EncodeOptions(level=level)
            gz = fgzip.compress(data, options=opts, engine="serial")
            assert pygzip.decompress(gz) == data
            hdr, _ = fgzip.Header.decode(gz)
            assert hdr.xfl == fgzip.CompressionLevel.xfl(level)

    def test_best_not_larger_than_fast(self):
        data = (b"abcdefgh" * 50 + b"abcdefgX" * 50) * 20
        fast = fgzip.compress(data, options=fgzip.EncodeOptions(
            level=fgzip.CompressionLevel.FAST), engine="serial")
        best = fgzip.compress(data, options=fgzip.EncodeOptions(
            level=fgzip.CompressionLevel.BEST), engine="serial")
        assert len(best) <= len(fast)

    def test_none_is_stored(self):
        data = b"incompressible-ish?"
        gz = fgzip.compress(data, options=fgzip.EncodeOptions(
            level=fgzip.CompressionLevel.NONE), engine="serial")
        assert pygzip.decompress(gz) == data
        # stored block: BTYPE 00 right after the 10-byte header
        assert gz[10] & 0b110 == 0


@pytest.mark.skipif(not native.available(), reason="no native toolchain")
class TestPgzfNative:
    def test_roundtrip_sizes(self):
        rng = np.random.default_rng(0)
        for n in (0, 1, 100, 65535, 65536, 65537, 300_000):
            data = bytes(rng.integers(0, 64, n, dtype=np.uint8))
            z = pgzf.compress(data, engine="native")
            assert pygzip.decompress(z) == data
            assert pgzf.decompress(z, engine="native") == data

    def test_threads_deterministic(self):
        data = bytes(np.random.default_rng(1).integers(
            0, 16, 500_000, dtype=np.uint8))
        z1 = pgzf.compress(data, engine="native", n_threads=1)
        z4 = pgzf.compress(data, engine="native", n_threads=4)
        assert z1 == z4                 # member-parallel => bit identical
        assert pgzf.decompress(z4, engine="native", n_threads=4) == data

    def test_corruption_detected(self):
        data = b"corrupt me " * 5000
        z = bytearray(pgzf.compress(data, engine="native"))
        z[len(z) // 2] ^= 0xFF
        with pytest.raises(Exception):
            pgzf.decompress(bytes(z), engine="native")

    def test_incompressible_stored_fallback(self):
        rnd = bytes(np.random.default_rng(2).integers(
            0, 256, 200_000, dtype=np.uint8))
        z = pgzf.compress(rnd, engine="native")
        # stored overhead only: must stay within ~0.5% of raw
        assert len(z) < len(rnd) * 1.01 + 1024
        assert pygzip.decompress(z) == rnd

    def test_cross_engine(self):
        # native-encoded stream decodes via device path and vice versa
        data = bytes(np.random.default_rng(3).integers(
            0, 8, 60_000, dtype=np.uint8))
        zn = pgzf.compress(data, member_size=8192, engine="native")
        assert pgzf.decompress(zn, engine="tpu") == data
        zt = pgzf.compress(data, member_size=8192, engine="tpu")
        assert pgzf.decompress(zt, engine="native") == data

    def test_device_knobs_through_options(self):
        """window / lazy ride EncodeOptions into the device encoder — a
        smaller window must round-trip and change the stream, runnable
        through the public API."""
        from libflate_tpu.serial.deflate import EncodeOptions

        rng = np.random.default_rng(5)
        words = [bytes(rng.integers(97, 123, 6, dtype=np.uint8))
                 for _ in range(30)]
        data = b" ".join(words[int(i) % 30] for i in
                         rng.zipf(1.3, 4000))[:16384]
        z_full = pgzf.compress(data, member_size=8192, engine="tpu",
                               options=EncodeOptions())
        z_small = pgzf.compress(
            data, member_size=8192, engine="tpu",
            options=EncodeOptions(window_size=1024, lazy=False))
        assert pygzip.decompress(z_small) == data
        assert pygzip.decompress(z_full) == data
        assert z_small != z_full     # the knobs actually reached the
        #                              matcher (1 KiB window, greedy)
