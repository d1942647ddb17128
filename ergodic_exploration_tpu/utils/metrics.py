"""Structured per-step metrics (SURVEY.md section 6, observability row).

Reference: ``ROS_INFO`` latency prints + RViz markers. Build-side: batched
:class:`StepDiagnostics` reduce to a flat dict of floats per engine step
(ergodic metric, barrier cost, fallback rate, divergence rate, solves/s),
ready for logging, JSONL dumps, or W&B-style sinks.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np


def summarize(diag, elapsed_s: Optional[float] = None) -> dict:
    """Reduce a (batched or per-tick-stacked) StepDiagnostics to floats.

    Works on (S,)-shaped replan output and (T, S)-shaped explore output.
    """
    em = np.asarray(diag.ergodic_metric, dtype=np.float64)
    out = {
        "ergodic_metric_mean": float(em.mean()),
        "ergodic_metric_p50": float(np.median(em)),
        "ergodic_metric_max": float(em.max()),
        "barrier_cost_mean": float(np.asarray(diag.barrier_cost, np.float64).mean()),
        "dwa_fallback_rate": float(np.asarray(diag.dwa_active, np.float64).mean()),
        # infeasible AMONG ACTIVE fallbacks: dwa_feasible is meaningful only
        # where dwa_active (elsewhere the DWA result is discarded)
        "dwa_infeasible_rate": float(np.asarray(
            np.asarray(diag.dwa_active) & ~np.asarray(diag.dwa_feasible),
            np.float64).mean()),
        "diverged_rate": float(np.asarray(diag.diverged, np.float64).mean()),
        # round-5 failure detection: how often the orbit guard reset a
        # scenario's warm start (closed-orbit attractor of the replan map)
        "orbit_reset_rate": float(np.asarray(diag.orbit_reset, np.float64).mean()),
        "collision_warn_rate": float((np.asarray(diag.collision_code) == 1).mean()),
        "collision_crash_rate": float((np.asarray(diag.collision_code) >= 2).mean()),
        "solves": int(em.size),
    }
    if elapsed_s is not None and elapsed_s > 0:
        out["elapsed_s"] = float(elapsed_s)
        out["solves_per_s"] = float(em.size / elapsed_s)
    return out


class MetricsLogger:
    """Tiny JSONL metrics sink with wall-clock timing between steps."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._t_last = time.perf_counter()
        self.history: list = []

    def log(self, diag, **extra) -> dict:
        now = time.perf_counter()
        rec = summarize(diag, elapsed_s=now - self._t_last)
        self._t_last = now
        rec.update(extra)
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec
