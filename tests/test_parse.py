"""Greedy parse of the device tokenizer (ops/pipeline._tokenize,
ops.lz77.parse_tokens) against the serial oracle (reference semantics:
libflate_lz77/src/default.rs:69-109 ``p += max(1, len[p])``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from libflate_tpu.ops import lz77  # noqa: E402


def _mixed_blocks(rng, lanes, n):
    blocks = np.zeros((lanes, n), np.uint8)
    for i in range(lanes):
        words = [bytes(rng.integers(97, 103, int(rng.integers(2, 9)),
                                    dtype=np.uint8)) for _ in range(30)]
        row = bytearray()
        while len(row) < n:
            row += words[int(rng.integers(0, 30))]
        blocks[i] = np.frombuffer(bytes(row[:n]), np.uint8)
    blocks[0] = rng.integers(0, 256, n)       # incompressible lane
    blocks[1] = 65                             # one giant run
    return blocks


class TestParse:
    def test_lazy_tokens_roundtrip_and_shrink(self):
        """Default lazy+TOO_FAR path and the greedy path: tokens expand
        back to the input, including a short member."""
        from libflate_tpu.ops import pipeline as pp
        from libflate_tpu.serial.lz77 import expand_tokens

        rng = np.random.default_rng(3)
        B, n = 8, 2048
        blocks = _mixed_blocks(rng, B, n)
        nv = np.full(B, n, np.int32)
        nv[5] = 513
        blocks[5, 513:] = 0
        blocks_j, nv_j = jnp.asarray(blocks), jnp.asarray(nv)

        for lazy in (True, False):
            a, b, cnt = map(np.asarray, pp._tokenize(blocks_j, nv_j,
                                                      lazy=lazy))
            for i in range(B):
                toks = list(zip(a[i, :cnt[i]].tolist(),
                                b[i, :cnt[i]].tolist()))
                assert bytes(expand_tokens(toks)) == \
                    blocks[i, :nv[i]].tobytes(), (lazy, i)

    @pytest.mark.parametrize("seed", range(3))
    def test_parse_tokens_matches_serial_walk(self, seed):
        """parse_tokens == the sequential ``p += max(1, len[p])`` walk
        over the same candidates and lengths."""
        rng = np.random.default_rng(seed)
        n = 1024
        data = _mixed_blocks(rng, 3, n)[2]
        cand = np.full(n, -1, np.int32)
        lengths = np.zeros(n, np.int32)
        for p in range(1, n):
            if rng.random() < 0.4:
                c = int(rng.integers(max(0, p - 300), p))
                ln = 0
                while (p + ln < n and ln < 258
                       and data[c + ln] == data[p + ln]):
                    ln += 1
                if ln >= 3:
                    cand[p], lengths[p] = c, ln
        nv = n - 7
        lengths = np.minimum(lengths, np.maximum(nv - np.arange(n), 0))
        lengths[lengths < 3] = 0
        a, b, cnt = map(np.asarray, lz77.parse_tokens(
            jnp.asarray(data), jnp.int32(nv), jnp.asarray(cand),
            jnp.asarray(lengths), n))
        want, p = [], 0
        while p < nv:
            if lengths[p]:
                want.append((int(lengths[p]), p - int(cand[p])))
                p += int(lengths[p])
            else:
                want.append((int(data[p]), 0))
                p += 1
        assert int(cnt) == len(want)
        assert list(zip(a[:cnt].tolist(), b[:cnt].tolist())) == want
