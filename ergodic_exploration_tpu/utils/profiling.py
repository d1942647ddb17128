"""Profiling utilities (SURVEY.md section 6, tracing row).

Reference: ROS_INFO loop-latency deltas. Build-side: ``jax.profiler`` trace
capture. Time a call on the host clock up to ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``jax.profiler`` trace (view in Perfetto/TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
