"""Share of the profiled stretch's wall time in which no device operation
ran: 100 x (1 - union of the operations' intervals / wall time). The
profiler slows the host, so this reads above an unprofiled run's."""


def read(t):
    p = t.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
