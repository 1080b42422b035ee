"""The SuperPoint network's share of the chip's bf16 peak over the whole
profiled stretch: its convolutions' FLOPs for the stretch's frames at the
padded frame shape (vobench/harness/counts.py), over the stretch's wall
time, against 989 TFLOP/s."""

from vobench.harness import counts


def read(t):
    p, s = t.get("profile"), t.get("stretch")
    if not p or not s or s["net_flops"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * s["net_flops"] / p["window_s"] / counts.PEAK_BF16_FLOPS
