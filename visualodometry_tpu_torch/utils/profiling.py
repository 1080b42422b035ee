"""Tracing / profiling hooks.

Port of visualodometry_tpu/utils/profiling.py. Two layers:
- `trace(log_dir)`: context manager around `torch.profiler` that writes a
  Chrome trace (open it in Perfetto or chrome://tracing) of the host and,
  on a CUDA machine, the device activity inside;
- `StageTimer`: named wall-clock accumulators for host-side per-stage
  timing (extract / step / BA / decode), reported as a summary dict.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(log_dir: str):
    """Host + device profiler trace into `log_dir/trace-<pid>-<ns>.json`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        )


class StageTimer:
    def __init__(self) -> None:
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": round(self._total[name], 4),
                "count": self._count[name],
                "mean_ms": round(1e3 * self._total[name] / max(self._count[name], 1), 3),
            }
            for name in self._total
        }
