"""The VO step's span per frame (lane-frames with lanes), in ms: the
harness's span around the engine's step (wrapped on the instance), each
ending in a synchronise, over the window outside the profiled stretch."""


def read(t):
    s = t["spans"].get("step")
    return None if not s or not s["frames"] else 1e3 * s["seconds"] / s["frames"]
