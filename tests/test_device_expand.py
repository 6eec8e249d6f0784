"""Device expansion (mod-collapse + pointer jumping) vs the serial
oracle."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from libflate_tpu.serial.lz77 import (chain_tokens, expand_tokens,
                                      greedy_tokens)


def _corpus(n, seed=7):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(200)]
    return b"\n".join(words[int(i)] for i in
                      rng.zipf(1.4, n // 3) % 200)[:n]


def _pack(tokens, t_cap):
    arr = np.zeros((t_cap,), np.int32)
    for i, (a, b) in enumerate(tokens):
        arr[i] = (a & 511) | (b << 9)
    return arr, len(tokens)


@pytest.mark.parametrize("matcher", ["greedy", "chain"])
def test_expand_members_matches_serial(matcher):
    from libflate_tpu.ops.device_expand import expand_members

    out_cap = 2048
    bsz = 4
    packed = np.zeros((bsz, 1024), np.int32)
    cnts = np.zeros((bsz,), np.int32)
    pieces = []
    for i in range(bsz):
        data = _corpus(out_cap if i % 2 else out_cap - 37, seed=i)
        toks = (greedy_tokens(data) if matcher == "greedy"
                else chain_tokens(data, max_chain=16, lazy=True))
        assert len(toks) <= 1024
        packed[i], cnts[i] = _pack(toks, 1024)
        pieces.append(data)
    out, n_out, err = expand_members(
        jnp.asarray(packed), jnp.asarray(cnts), out_cap)
    out, n_out, err = map(np.asarray, (out, n_out, err))
    assert not err.any()
    for i, data in enumerate(pieces):
        assert n_out[i] == len(data)
        assert out[i, :n_out[i]].tobytes() == data


def test_expand_members_rle_runs():
    """Deep RLE chains (dist < len) collapse via the mod trick."""
    from libflate_tpu.ops.device_expand import expand_members

    out_cap = 4096
    cases = [
        b"a" * 4000,                              # dist-1 run
        b"ab" * 1800,                             # dist-2 run
        b"xyz" + b"xyz" * 1000,                   # dist-3
        bytes(range(250)) * 16,                   # dist-250 pure copies
    ]
    packed = np.zeros((len(cases), 2048), np.int32)
    cnts = np.zeros((len(cases),), np.int32)
    for i, data in enumerate(cases):
        toks = greedy_tokens(data)
        packed[i], cnts[i] = _pack(toks, 2048)
    out, n_out, err = expand_members(
        jnp.asarray(packed), jnp.asarray(cnts), out_cap)
    out, n_out, err = map(np.asarray, (out, n_out, err))
    assert not err.any()
    for i, data in enumerate(cases):
        assert out[i, :n_out[i]].tobytes() == data


def test_expand_members_bad_distance_flagged():
    from libflate_tpu.ops.device_expand import expand_members

    packed = np.zeros((1, 8), np.int32)
    packed[0, 0] = ord("x")                      # literal
    packed[0, 1] = 5 | (3 << 9)                  # dist 3 > history 1
    out, n_out, err = expand_members(
        jnp.asarray(packed), jnp.asarray([2], np.int32), 1024)
    assert bool(np.asarray(err)[0])


def test_expand_members_overflow_flagged():
    from libflate_tpu.ops.device_expand import expand_members

    packed = np.zeros((1, 64), np.int32)
    packed[0, 0] = ord("q")
    for i in range(1, 64):
        packed[0, i] = 258 | (1 << 9)
    out, n_out, err = expand_members(
        jnp.asarray(packed), jnp.asarray([64], np.int32), 1024)
    assert bool(np.asarray(err)[0])
