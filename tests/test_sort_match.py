"""Sort-based candidate finder (ops/sort_match) vs brute force."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp


@pytest.mark.parametrize("window,scan_k", [(512, 8), (1024, 2), (64, 8)])
def test_sort_candidates_vs_bruteforce(window, scan_k):
    from libflate_tpu.ops.sort_match import M_EXACT, sort_candidates

    rng = np.random.default_rng(3)
    n = 1024
    words = [bytes(rng.integers(97, 103, rng.integers(3, 8),
                                dtype=np.uint8)) for _ in range(30)]
    data = b"".join(words[int(i)] for i in rng.zipf(1.3, 1200) % 30)[:n]
    arr = np.frombuffer(data, np.uint8)[None, :].copy()
    cand, m = map(np.asarray, sort_candidates(
        jnp.asarray(arr), window=window, scan_k=scan_k))

    def pref(a, b, cap=M_EXACT):
        length = 0
        while (length < cap and b + length < len(data)
               and data[a + length] == data[b + length]):
            length += 1
        return length

    # every reported candidate is in-window with the claimed EXACT
    # shared length (clipped to M_EXACT; padding zeros past the member
    # end can only inflate claims in the last M_EXACT bytes)
    for p in range(n):
        c = int(cand[0, p])
        if c >= 0:
            assert 0 < p - c <= window
            assert 3 <= m[0, p] <= M_EXACT
            if p + M_EXACT <= n:
                assert pref(c, p) == int(m[0, p]), p

    # the nearest exact 4-byte repeat is never missed
    seen = {}
    for p in range(n - 4):
        key = data[p:p + 4]
        if key in seen and p - seen[key] <= window:
            assert int(cand[0, p]) >= 0 and int(m[0, p]) >= 4, p
        seen[key] = p
