"""Kernel K1 (ops/match_top2.py -> csrc/match_top2.cu): the least time
its calls in the profiled stretch could take, over their device time, in
%. The least time is the larger of the operations (3 x 2 x n0 x n1 x d,
valid rows only, at the TF32 rate) and the bytes (at HBM's rate), counted
by vobench/harness/counts.py."""

from vobench.harness import counts

KERNELS = ("match_top2_kernel", "merge_splits_kernel")


def read(t):
    p, s = t.get("profile"), t.get("stretch")
    if not p or not s:
        return None
    dev = sum(v for k, v in p["device_time"].items() if any(n in k for n in KERNELS))
    if dev <= 0 or s["k1_flops"] <= 0:
        return None
    least, _ = counts.least_seconds(s["k1_flops"], s["k1_bytes"], counts.PEAK_TF32_FLOPS)
    return 100.0 * least / dev
