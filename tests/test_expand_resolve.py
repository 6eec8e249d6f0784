"""Pointer jumping (ops/device_expand.resolve_bytes) vs a numpy
oracle."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp


def _oracle(src, lit):
    n = len(src)
    out = np.zeros(n, np.int32)
    for p in range(n):
        s = src[p]
        while src[s] != s:
            s = src[s]
        out[p] = lit[s]
    return out


def _random_case(rng, n):
    """Random strictly-decreasing pointer map with literal fixpoints,
    including long in-block chains and far cross-block hops."""
    src = np.arange(n, dtype=np.int32)
    lit = rng.integers(0, 256, n).astype(np.int32)
    for p in range(1, n):
        r = rng.random()
        if r < 0.35:
            continue                       # literal root
        if r < 0.75:
            src[p] = p - 1                 # deep chain
        else:
            src[p] = int(rng.integers(0, p))
    return src, lit


@pytest.mark.parametrize("n", [1024, 4096])
def test_resolve_bytes_random(n):
    from libflate_tpu.ops.device_expand import resolve_bytes

    rng = np.random.default_rng(3)
    srcs, lits, want = [], [], []
    for b in range(3):
        src, lit = _random_case(rng, n)
        srcs.append(src)
        lits.append(lit)
        want.append(_oracle(src, lit))
    out = np.asarray(jax.vmap(resolve_bytes)(jnp.asarray(np.stack(srcs)),
                                             jnp.asarray(np.stack(lits))))
    assert (out == np.stack(want)).all()


def test_resolve_bytes_worst_case_chain():
    """One chain spanning the whole member: src[p] = p - 1."""
    from libflate_tpu.ops.device_expand import resolve_bytes

    n = 2048
    src = np.maximum(np.arange(n, dtype=np.int32) - 1, 0)
    lit = np.zeros(n, np.int32)
    lit[0] = 77
    out = np.asarray(resolve_bytes(jnp.asarray(src), jnp.asarray(lit)))
    assert (out == 77).all()
