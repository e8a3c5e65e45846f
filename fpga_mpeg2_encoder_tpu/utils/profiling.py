"""Lightweight stage profiling for the encoder pipeline.

The reference's only performance artifacts are synthesis timing tables
(README.md:252-262); the framework-native equivalent is (a) `bench.py` for the
headline number and (b) this helper for per-call wall timing.  Device work
is asynchronous, so a stage's time means something only if the caller forces
completion inside the block.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class StageTimer:
    """Accumulates wall time per named stage.

    Note: on asynchronous backends a stage's time is only meaningful if the
    caller forces completion inside the block (e.g. scalar readback)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> List[str]:
        out = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            out.append(f"{name:24s} {tot * 1000:9.2f} ms total"
                       f"  ({tot / n * 1000:8.2f} ms x {n})")
        return out


def trace_to(path: str):
    """Context manager: capture a JAX profiler trace (viewable in TensorBoard /
    Perfetto) around the enclosed device work."""
    import jax

    return jax.profiler.trace(path)
