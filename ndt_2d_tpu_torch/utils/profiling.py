"""Tracing, timing and session metrics: the port's copy of
``ndt_2d_tpu/utils/profiling.py``.

The reference has no profiling or metrics subsystem at all — its only
quality signal is a log line of match scores (SURVEY.md section 5.1).  The
host runtime keeps cheap aggregate statistics that the CLI reports per
session; device traces come from ``torch.profiler`` (``device_trace``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the body with ``torch.profiler`` (host activity, and the CUDA
    kernels and copies where PyTorch sees a card) and write it as a Chrome
    trace, ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class Timer:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(self.total[k], 4),
                "count": self.count[k],
                "mean_ms": round(1e3 * self.total[k] / max(self.count[k], 1),
                                 3)}
            for k in sorted(self.total)
        }


class SessionStats:
    """Aggregate SLAM session statistics (scans, scores, closures)."""

    def __init__(self):
        self.scans_processed = 0
        self.scans_accepted = 0
        self.loop_closures_accepted = 0
        self.loop_closures_rejected = 0
        # Far-candidate pruning (config.loop_closure_far_dedup /
        # _reject_cache_margin): rows dropped by the per-pass spatial dedup
        # and candidates skipped by the cross-pass negative cache.
        self.far_rows_pruned = 0
        self.far_rows_cache_skipped = 0
        # Confirmation rows whose result was reused across a pass restart.
        self.confirm_rows_reused = 0
        self.optimizations = 0
        self.score_sum = 0.0
        self.score_min = 0.0
        self.timer = Timer()

    def record_scan(self, accepted: bool, score: Optional[float] = None):
        self.scans_processed += 1
        if accepted:
            self.scans_accepted += 1
            if score is not None:
                self.score_sum += score
                self.score_min = min(self.score_min, score)

    def summary(self) -> dict:
        n = max(self.scans_accepted, 1)
        return {
            "scans_processed": self.scans_processed,
            "scans_accepted": self.scans_accepted,
            "mean_match_score": round(self.score_sum / n, 4),
            "best_match_score": round(self.score_min, 4),
            "loop_closures_accepted": self.loop_closures_accepted,
            "loop_closures_rejected": self.loop_closures_rejected,
            "far_rows_pruned": self.far_rows_pruned,
            "far_rows_cache_skipped": self.far_rows_cache_skipped,
            "confirm_rows_reused": self.confirm_rows_reused,
            "optimizations": self.optimizations,
            "timing": self.timer.summary(),
        }
