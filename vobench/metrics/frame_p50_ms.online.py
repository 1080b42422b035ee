"""Median time of one `VOEngine.process_frame` call over the traced
window, in ms (host clock around the call; the pose is on the host when
it returns)."""

import statistics


def read(t):
    lat = t.get("latencies_s")
    return 1e3 * statistics.median(lat) if lat else None
