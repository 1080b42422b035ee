"""The benchmark's own spans, sync counts and device-trace reading.

Spans sit in the harness, around its calls into each layer of the program
(extraction, the VO step); each ends in `torch.cuda.synchronize()`, so it
times the layer's device work too. Host synchronisations inside a span are
counted as scripts/profile_torch_main_path.py counts them: every
synchronising CUDA call warns under `torch.cuda.set_sync_debug_mode`. All
of it runs in the `--trace 1` run only.

The profiled stretch's arithmetic copies chip_smoke.py's `union_us`: busy
time is the union of the device operations' intervals, so overlapping
kernels count once and gaps count not at all.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict

import torch


def union_us(ranges) -> float:
    """Total length of the union of [start, end) intervals."""
    total = 0.0
    end_max = None
    for s, e in sorted(ranges):
        if end_max is None or s > end_max:
            total += e - s
            end_max = e
        elif e > end_max:
            total += e - end_max
            end_max = e
    return total


class Spans:
    """Per-layer span totals: seconds, calls, frames, host syncs."""

    def __init__(self, device: torch.device, enabled: bool):
        self.on = enabled
        self.cuda = device.type == "cuda"
        self.seconds = defaultdict(float)
        self.frames = defaultdict(int)
        self.calls = defaultdict(int)
        self.syncs = defaultdict(int)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str, frames: int):
        if not self.on:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        if self.cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield
        finally:
            if self.cuda:
                torch.cuda.set_sync_debug_mode("default")
        self._sync()
        self.seconds[name] += time.perf_counter() - t0
        self.frames[name] += frames
        self.calls[name] += 1
        self.syncs[name] += sum("synchroniz" in str(w.message) for w in caught)

    def summary(self) -> dict:
        return {k: {"seconds": self.seconds[k], "frames": self.frames[k],
                    "calls": self.calls[k], "syncs": self.syncs[k]} for k in self.seconds}


def read_profile(prof, wall_s: float) -> dict:
    """Busy time, kernels, device time by name, and the longest idle gaps
    from a torch.profiler run, each gap named by the harness span open over
    it and the innermost host operation running then."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if kind == "CUDA":
            # the harness's own annotations also appear on the device's
            # timeline; they are ranges, not work
            if not (span[2].startswith("vobench.") or getattr(e, "is_user_annotation", bool)()):
                dev.append(span)
        else:
            host.append(span)
    busy_ns = union_us([(s, t) for s, t, _ in dev])
    by_name = defaultdict(float)
    kernels = 0
    for s, t, n in dev:
        by_name[n] += (t - s) * 1e-9
        kernels += not n.startswith(("Memcpy", "Memset"))
    gaps, last_end = [], None
    for s, t, _ in sorted(dev):
        if last_end is not None and s > last_end:
            gaps.append((s - last_end, last_end, s))
        last_end = t if last_end is None else max(last_end, t)
    gaps.sort(reverse=True)
    named = []
    for g, a, b in gaps[:10]:
        mid = (a + b) / 2
        over = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
        outer = next((n for _, n in sorted(over, reverse=True) if n.startswith("vobench.")),
                     "vobench.other")
        ops = [o for o in over if o[1].startswith(("aten::", "cuda"))]
        inner = min(ops)[1] if ops else "python"
        named.append([f"{outer} > {inner}", g * 1e-9])
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": wall_s, "busy_s": busy_ns * 1e-9, "kernels": kernels,
        "device_time": dict(by_name), "device_ops": [[n[:200], s] for n, s in top_ops],
        "idle_gaps": named,
    }
