"""Device kernels in the profiled stretch (copies and fills left out),
per frame (lane-frames with lanes)."""


def read(t):
    p, s = t.get("profile"), t.get("stretch")
    if not p or not s or not p["kernels"]:
        return None
    return p["kernels"] / s["lane_frames"]
