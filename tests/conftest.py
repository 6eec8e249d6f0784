"""Test configuration: JAX on a virtual 8-device CPU mesh by default.

Tests need no accelerator: the one Pallas kernel runs in the Pallas
interpreter on the CPU and multi-device sharding runs on virtual host
devices.  Tests marked ``gpu`` run only where JAX finds a GPU (set
``JAX_PLATFORMS=cuda`` there).
"""
import hashlib
import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# Persistent compile cache: the long many-compile suite process
# occasionally segfaults INSIDE an XLA:CPU backend_compile (never on
# cached compiles), so reruns read compiled programs from disk.  The
# directory is keyed by the host's CPU feature flags: loading an AOT
# executable compiled for a DIFFERENT feature set SIGILLs.  Where
# JAX_COMPILATION_CACHE_DIR is set, JAX uses that and nothing else.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _flags = ""
    try:
        with open("/proc/cpuinfo") as _f:
            for _line in _f:
                if _line.startswith("flags"):
                    _flags = _line
                    break
    except OSError:
        pass
    _CPU_CACHE = (pathlib.Path(__file__).parent.parent / (
        ".jax_cache_cpu-" + hashlib.sha256(_flags.encode()).hexdigest()[:8]))
    jax.config.update("jax_compilation_cache_dir", str(_CPU_CACHE))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import random  # noqa: E402
import zlib as pyzlib  # noqa: E402

import pytest  # noqa: E402

DATA_DIR = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA_DIR


def _corpus() -> list[bytes]:
    rng = random.Random(1234)
    return [
        b"",
        b"a",
        b"Hello World!",
        b"aaaaaaaaaaaaaaaaaaaa",
        b"abcabcabcabcabcabc" * 40,
        bytes(rng.randrange(256) for _ in range(4096)),
        (b"The quick brown fox jumps over the lazy dog. " * 150),
        bytes(rng.randrange(4) for _ in range(10000)),     # low entropy
        b"\x00" * 5000,
    ]


@pytest.fixture(scope="session")
def corpus() -> list[bytes]:
    return _corpus()


@pytest.fixture(scope="session")
def zlib_oracle():
    """Python stdlib zlib as the byte-exactness interop oracle."""
    return pyzlib
