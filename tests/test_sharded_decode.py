"""Member-parallel XLA decode over the 8-device virtual CPU mesh."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")


class TestShardedDecode:
    def test_decode_members_sharded(self):
        import zlib as pyzlib

        from libflate_tpu.parallel.mesh import make_mesh
        from libflate_tpu.parallel.sharding import (decode_members_sharded,
                                                    encode_blocks_sharded)
        mesh = make_mesh(8)
        rng = np.random.default_rng(2)
        bsz, n = 8, 1024
        blocks = rng.integers(0, 8, (bsz, n), dtype=np.uint8)
        n_valid = np.full((bsz,), n, np.int32)
        bfinal = np.ones((bsz,), np.int32)
        words, bits = encode_blocks_sharded(blocks, n_valid, bfinal, mesh)
        # frame each block body, parse its header back, decode sharded
        from libflate_tpu.ops.deflate_encode import splice_blocks_host
        from libflate_tpu.serial.bitio import BitReader
        from libflate_tpu.serial.deflate import read_dynamic_header_lengths
        lit_ls = np.zeros((bsz, 286), np.int32)
        dist_ls = np.zeros((bsz, 30), np.int32)
        starts = np.zeros((bsz,), np.int32)
        wmax = words.shape[1]
        dwords = np.zeros((bsz, wmax + 2), np.uint32)
        for i in range(bsz):
            body = splice_blocks_host(words[i:i + 1], bits[i:i + 1])
            d = pyzlib.decompressobj(-15)
            assert d.decompress(body) == blocks[i].tobytes()
            r = BitReader(body)
            r.read_bits(3)
            lit_ls[i], dist_ls[i] = read_dynamic_header_lengths(r)
            starts[i] = r.bit_position
            arr = np.frombuffer(body + b"\x00" * ((-len(body)) % 4),
                                np.uint8)
            dwords[i, :len(arr) // 4] = arr.view("<u4")
        out, n_out, err = decode_members_sharded(
            dwords, starts, lit_ls, dist_ls, n, mesh)
        assert not err.any()
        assert (n_out == n).all()
        assert (out == blocks).all()
