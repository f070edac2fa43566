"""Structured timing + profiler hooks.

Replaces the reference's commented-out ``time.time()`` breadcrumbs and ad-hoc
prints (SURVEY §5: voxel.py:105-168, estimate_normals.py:38-84,
registration.py:91-92) with a first-class phase timer and a ``jax.profiler``
trace wrapper for device timeline capture.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    Device work is asynchronous under JAX; phases that end at a device
    boundary should pass ``block=...`` an array (or pytree) to fence on, so
    the recorded time covers the compute, not just the dispatch.

        timer = PhaseTimer()
        with timer.phase("voxelize"):
            vm = build_voxel_map(...)
        with timer.phase("align", block_on=lambda: result.T):
            result = align(...)
        print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on() if callable(block_on) else block_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in self.totals:
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:24s} {tot * 1e3:9.2f} ms total  x{n}  {tot / n * 1e3:8.2f} ms/call")
        return "\n".join(lines)

    def as_dict(self) -> dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``jax.profiler`` trace (viewable in TensorBoard/Perfetto)
    around a block of device work."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
