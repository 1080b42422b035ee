"""Kernel K2 (ops/patches.py -> csrc/patches.cu): the least time its
calls in the profiled stretch could take (each field read once, each
valid keypoint's window written once, at HBM's rate), over their device
time, in %."""

from vobench.harness import counts

KERNELS = ("patch_tma_kernel", "patch_scalar_kernel")


def read(t):
    p, s = t.get("profile"), t.get("stretch")
    if not p or not s or not s.get("k2_bytes"):
        return None
    dev = sum(v for k, v in p["device_time"].items() if any(n in k for n in KERNELS))
    if dev <= 0:
        return None
    least, _ = counts.least_seconds(0.0, s["k2_bytes"], counts.PEAK_BF16_FLOPS)
    return 100.0 * least / dev
