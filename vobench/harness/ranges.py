"""The program's `vo.*` profiler ranges, read against the device trace.

While the program's recorder (visualodometry_tpu_torch/utils/profiling.py)
is on, each of its spans opens a `torch.profiler.record_function` range
named `vo.<span>`; under a running profiler those ranges lie on the
device events' clock. `read_ranges(prof)` puts two things of a profiled
stretch down to the range the host was in, by the range's self time (its
interval less the ranges nested in it):

- kernel launches: the runtime calls `cudaLaunchKernel`, `cuLaunchKernel`
  and `cudaLaunchKernelExC`, each by the time it started;
- device idle time: the gaps between the device operations, found as
  vobench/harness/trace.py `read_profile` finds them (operations sorted by
  start; a gap opens where one starts after every earlier one has ended),
  split wherever a range opens or closes.

Times outside every `vo.*` range go under None. Intervals are half-open,
[start, end): a launch at a range's first nanosecond is the range's, one
at its end is its parent's.
"""

from __future__ import annotations

import bisect

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
PREFIX = "vo."


def owners(ranges):
    """The innermost range over each stretch of the timeline: a sorted
    list of (start, name or None), each owning up to the next start.
    `ranges` are (start, end, name) and nest, as one thread's ranges do;
    of two that open together, the one that ends later is the outer."""
    edges = []
    for i, (s, e, _) in enumerate(ranges):
        if e > s:  # an empty range owns no time
            edges += [((s, 1, -e), i), ((e, 0, 0), i)]
    edges.sort()  # at one time: closes, then opens, the outer first
    out, open_ = [], []
    for k, ((t, is_open, _), i) in enumerate(edges):
        if is_open:
            open_.append(i)
        else:
            open_.remove(i)
        if k + 1 < len(edges) and edges[k + 1][0][0] == t:
            continue
        out.append((t, ranges[open_[-1]][2] if open_ else None))
    return out


def attribute(ranges, launches, device) -> dict:
    """`ranges`: (start, end, name) of the `vo.*` ranges; `launches`: the
    host start of each kernel launch; `device`: (start, end) of each device
    operation. Returns {"ranges": {name: {"launches": n, "idle_ns": t}}
    (name None: outside every range), "launches": n, "idle_ns": t}."""
    table = owners(ranges)
    starts = [t for t, _ in table]
    by = {}

    def slot(name):
        return by.setdefault(name, {"launches": 0, "idle_ns": 0})

    for t in launches:
        k = bisect.bisect_right(starts, t) - 1
        slot(table[k][1] if k >= 0 else None)["launches"] += 1
    gaps, last_end = [], None
    for s, e in sorted(device):
        if last_end is not None and s > last_end:
            gaps.append((last_end, s))
        last_end = e if last_end is None else max(last_end, e)
    idle = 0
    for a, b in gaps:
        idle += b - a
        k = bisect.bisect_right(starts, a) - 1
        t = a
        while t < b:
            name = table[k][1] if k >= 0 else None
            nxt = starts[k + 1] if k + 1 < len(starts) else b
            end = min(b, nxt)
            slot(name)["idle_ns"] += end - t
            t, k = end, k + 1
    return {"ranges": by, "launches": len(launches), "idle_ns": idle}


def read_ranges(prof) -> dict:
    """`attribute` over a torch.profiler run's events, by range name with
    the `vo.` prefix taken off; times in seconds."""
    ranges, launches, device = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        name = e.name()
        s = e.start_ns()
        t = s + e.duration_ns()
        if kind == "CUDA":
            if not (name.startswith(("vobench.", PREFIX))
                    or getattr(e, "is_user_annotation", bool)()):
                device.append((s, t))
        elif name.startswith(PREFIX):
            ranges.append((s, t, name[len(PREFIX):]))
        elif name in LAUNCHES:
            launches.append(s)
    got = attribute(ranges, launches, device)
    return {
        "ranges": {n: {"launches": v["launches"], "idle_s": v["idle_ns"] * 1e-9}
                   for n, v in got["ranges"].items()},
        "launches": got["launches"], "idle_s": got["idle_ns"] * 1e-9,
    }
