"""Compiled-kernel checks that need the GPU (marker ``gpu``).

They skip on a machine without one.  Run on the card:
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402


@pytest.fixture()
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend")


def _text(n, seed=3):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(400)]
    return b"\n".join(words[int(i)] for i in
                      rng.zipf(1.4, n // 3) % 400)[:n]


@pytest.mark.gpu
def test_compiled_sync_kernel_matches_xla_twin(gpu):
    from libflate_tpu.formats import pgzf
    from libflate_tpu.ops import sync_decode as sd

    stream = pgzf.compress(_text(1 << 20), engine="tpu")
    refs = pgzf.index_members(stream)
    plan = pgzf._sync_plan(stream, refs)
    args, _lo, _hi = pgzf._chunk_args(plan, np.arange(len(refs)),
                                      len(refs))
    args = [jnp.asarray(a) for a in args]
    lit_t, dist_t = sd.decode_tables(plan.lit_lengths, plan.dist_lengths,
                                     plan.root_bits)
    words = jnp.asarray(plan.words)
    tk, ek = sd.sync_decode(words, *args, lit_t, dist_t,
                            root_bits=plan.root_bits)
    tx, ex = sd.sync_decode_xla(words, *args, lit_t, dist_t,
                                root_bits=plan.root_bits)
    assert (np.asarray(tk) == np.asarray(tx)).all()
    assert (np.asarray(ek) == np.asarray(ex)).all()


@pytest.mark.gpu
def test_crc_matmuls_exact_on_gpu(gpu):
    from libflate_tpu.ops.checksum import crc32_f_rows, crc32_from_padded_f

    rows = np.random.default_rng(0).integers(0, 256, (64, 65536),
                                             dtype=np.uint8)
    got = crc32_from_padded_f(np.asarray(crc32_f_rows(jnp.asarray(rows))),
                              np.full(64, 65536), 65536)
    assert got.tolist() == [zlib.crc32(r.tobytes()) for r in rows]
