"""The program's one recorder: host-time spans and counters at its layer
boundaries, off by default.

The extractors, the VO step and the engine open `span(name)` around their
phases and call `count(name, n)` at their host reads. While the recorder is
off (`enable(False)`, the default) `span` hands back one shared no-op
context and `count` returns at once: a global read each, no clock read, no
allocation, no torch call. `enable(True)` turns on the process-wide
`StageTimer`; `summary()` reads it and `reset()` clears it.

A span records host time only (`time.perf_counter_ns`), with the span open
around it as its parent, and the frame it fell in (a span opened with
`frame=True`, the step's, starts a frame). It is aggregated in memory by
name: calls, total and self time (total less the time of the spans inside
it), parent, frames; nothing grows with the number of frames.

Spans do not synchronise. The step is host-bound (the device idles most of
each frame) and already reads the device twice a frame; a synchronise at
each span's edge would add reads the step does not make and change what
is measured. So a span around enqueued work times its dispatch, and the
spans around the step's host reads (`step.read_gates`, `step.read_flags`)
and the engine's copy to the host (`readback`) hold the time the host
waits for the device: together they account for the frame without a
single added read.

While on, each span also opens `torch.profiler.record_function("vo.<name>")`:
under a running `torch.profiler` the spans lie on the same timeline as the
device's events, so a device idle gap can be put down to the span the host
was in.

The recorder nests spans on one stack: it expects the thread that runs
the step to be the only one recording.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class _Stat:
    __slots__ = ("calls", "total_ns", "self_ns", "parent", "frames", "last_frame")

    def __init__(self):
        self.calls = self.total_ns = self.self_ns = self.frames = 0
        self.parent = None
        self.last_frame = -1


class StageTimer:
    """Named host-time spans and counters, aggregated in memory.

    `stage(name)` times the block it wraps; a stage opened inside another
    is its child, and its time is left out of the parent's self time.
    `add(name, n)` adds to a counter. `summary()` gives, for each stage,
    `total_s`, `self_s`, `count`, `mean_ms`, `parent` and `frames`, and for
    each counter `count`.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._stats: dict[str, _Stat] = defaultdict(_Stat)
        self._counters: dict[str, int] = defaultdict(int)
        self._stack: list[list] = []  # open stages: [name, children's ns]
        self.frame = 0  # frames started (stages opened with frame=True)

    @contextlib.contextmanager
    def stage(self, name: str, frame: bool = False):
        if frame:
            self.frame += 1
        parent = self._stack[-1] if self._stack else None
        entry = [name, 0]
        self._stack.append(entry)
        with torch.profiler.record_function(f"vo.{name}"):
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                dt = time.perf_counter_ns() - t0
                self._stack.pop()
                s = self._stats[name]
                s.calls += 1
                s.total_ns += dt
                s.self_ns += dt - entry[1]
                s.parent = None if parent is None else parent[0]
                if s.last_frame != self.frame:
                    s.frames += 1
                    s.last_frame = self.frame
                if parent is not None:
                    parent[1] += dt

    def add(self, name: str, n: int = 1) -> None:
        self._counters[name] += n

    def summary(self) -> dict[str, dict]:
        out = {
            name: {
                "total_s": s.total_ns * 1e-9,
                "self_s": s.self_ns * 1e-9,
                "count": s.calls,
                "mean_ms": s.total_ns * 1e-6 / max(s.calls, 1),
                "parent": s.parent,
                "frames": s.frames,
            }
            for name, s in self._stats.items()
        }
        out.update({name: {"count": n} for name, n in self._counters.items()})
        return out


_NULL = contextlib.nullcontext()
_RECORDER = StageTimer()
_on = False


def enable(on: bool) -> None:
    """Turn the process-wide recorder on or off; what it holds is kept."""
    global _on
    _on = bool(on)


def reset() -> None:
    """Clear the process-wide recorder."""
    _RECORDER.reset()


def span(name: str, frame: bool = False):
    """A context that records `name` while the recorder is on (and opens
    the `vo.<name>` profiler range); a shared no-op context while it is
    off. `frame=True` starts a frame."""
    if not _on:
        return _NULL
    return _RECORDER.stage(name, frame)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while the recorder is on."""
    if _on:
        _RECORDER.add(name, n)


def summary() -> dict[str, dict]:
    """The process-wide recorder's `StageTimer.summary()`."""
    return _RECORDER.summary()
