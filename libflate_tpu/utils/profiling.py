"""Profiling / tracing helpers (SURVEY.md §5 aux-subsystem parity).

The reference has only a wall-clock bench (flate_bench); the
framework exposes `jax.profiler` traces plus a lightweight stage-timer
so pipelines can be rooflined per kernel.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulates wall time per named pipeline stage."""
    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.times.values()) or 1e-12
        lines = [f"{n:24s} {t * 1000:9.2f} ms  {t / total * 100:5.1f}%  "
                 f"(x{self.counts[n]})"
                 for n, t in sorted(self.times.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/libflate_trace"):
    """jax.profiler trace context; view with TensorBoard / xprof."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def block_until_ready(tree):
    """Sync helper so StageTimer measures device work, not dispatch."""
    import jax
    return jax.block_until_ready(tree)
