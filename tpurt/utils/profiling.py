"""Profiling hooks.

The reference's only instrumentation is wall-clock around the tile loop
(src/image.hpp:283,316-323). Here: a context manager around
jax.profiler for full XLA traces (view in TensorBoard/Perfetto), plus a
lightweight phase timer whose readings force host materialisation, so
a reading always includes the device work it waited for.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np

import jax


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/tpurt-trace"):
    """Capture an XLA profiler trace of the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def materialize(tree) -> None:
    """Force every array in a pytree to the host (honest sync point)."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "shape"):
            np.asarray(leaf)


class PhaseTimer:
    """Accumulates wall time per named phase with honest sync points.

    >>> t = PhaseTimer()
    >>> with t.phase("render"):
    ...     out = render_tile(...)
    ...     materialize(out)
    >>> t.report()
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                materialize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> List[str]:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total:.3f}s total, {n}x, {total/n*1e3:.1f}ms avg")
        return lines

    def __str__(self) -> str:
        return "\n".join(self.report())
