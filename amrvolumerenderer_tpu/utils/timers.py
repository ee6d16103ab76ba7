"""Stage timing and profiling utilities.

The reference reports per-stage wall times reduced with MPI_Reduce(MAX)
and printed on rank 0 (VolumeRenderer.cpp:1121-1136): "Render: <label>
took <s> s" for per-box rendering, visibility graph computation and
compositing.  In the single-controller JAX model the max-over-ranks
reduction is implicit (one host measures the bulk-synchronous stages);
this module reproduces the same report format and adds optional
``jax.profiler`` trace capture for device-level analysis.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


class StageTimers:
    """Accumulates named stage durations and prints reference-format lines."""

    def __init__(self, verbose: bool = True):
        self.verbose = verbose
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, label: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.stages[label] = self.stages.get(label, 0.0) + elapsed
            if self.verbose:
                print(f"Render: {label} took {elapsed:.4f} s")

    def report(self) -> Dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a jax.profiler trace around a block when ``log_dir`` is set.

    View with TensorBoard or Perfetto; the JAX replacement for the
    reference's wall-clock-only instrumentation.
    """
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
