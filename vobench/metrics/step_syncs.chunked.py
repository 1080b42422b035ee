"""Host synchronisations inside the VO step per frame (lane-frames with
lanes): each synchronising CUDA call warns under
`torch.cuda.set_sync_debug_mode("warn")` and is counted."""


def read(t):
    s = t["spans"].get("step")
    return None if not s or not s["frames"] else s["syncs"] / s["frames"]
