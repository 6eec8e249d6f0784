"""Multi-host member sharding (SURVEY §2.3.5): 2-process CPU validation.

A real ``jax.distributed`` pair of subprocesses round-trips a corpus
through compress_multihost/decompress_multihost and cross-checks the
combined CRC; the single-process degenerate path runs in-process.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from libflate_tpu.parallel import multihost


def _corpus(n, seed=3):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(300)]
    return b"\n".join(words[int(i)] for i in
                      rng.zipf(1.4, n // 3) % 300)[:n]


def test_single_process_degenerates_to_pgzf():
    data = _corpus(300000)
    stream = multihost.compress_multihost(data, member_size=65536)
    from libflate_tpu.formats import pgzf
    assert stream == pgzf.compress(data, member_size=65536)
    assert multihost.decompress_multihost(stream) == data
    from libflate_tpu import backend
    assert multihost.corpus_crc32_multihost(data) == \
        backend.get(None).crc32(data)


def test_slab_bounds_cover_and_align():
    total, ms = 1000000, 65536
    n = 3
    spans = [multihost.slab_bounds(total, ms, p, n) for p in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == total
    for (l0, h0), (l1, h1) in zip(spans, spans[1:]):
        assert h0 == l1 and l0 % ms == 0


_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from libflate_tpu.parallel import multihost

    coord, n, pid, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), 3
    multihost.init_distributed(coord, n, pid)
    assert jax.process_count() == n

    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 10),
                                dtype=np.uint8)) for _ in range(300)]
    data = b"\\n".join(words[int(i)] for i in
                       rng.zipf(1.4, 200000) % 300)[:600000]

    stream = multihost.compress_multihost(data, member_size=65536)
    out = multihost.decompress_multihost(stream)
    assert out == data, "multi-host round-trip mismatch"
    from libflate_tpu.formats import pgzf
    assert stream == pgzf.compress(data, member_size=65536), \\
        "multi-host stream != single-host stream"
    from libflate_tpu import backend
    assert (multihost.corpus_crc32_multihost(data)
            == backend.get(None).crc32(data)), "combined CRC mismatch"
    print(f"proc {pid} OK")
""")


def test_two_process_roundtrip(tmp_path):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{port.getsockname()[1]}"
    port.close()

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root] + env.get("PYTHONPATH", "").split(os.pathsep))
    env.pop("XLA_FLAGS", None)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), addr, "2", str(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed: {err[-2000:]}"
        assert "OK" in out
