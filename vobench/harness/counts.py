"""The yardstick: published peaks, and the operations and bytes of each
kernel call and of the SuperPoint network, counted from shapes.

Frozen here so that later changes to the program cannot move it. The K1
and K2 counts follow the bounds of the port's chip_smoke.py (`bound_ms`,
PERF.md's kernel table) with the rule that only what the call's inputs
need is counted: valid descriptor rows for K1, valid keypoints' windows
for K2. The octave shapes are a copy of `patch_launches` and its helpers
in visualodometry_tpu_torch/frontend/sift.py.
"""

from __future__ import annotations

import math

# Published NVIDIA H100 SXM peaks (data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12  # HBM3


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """The least time the chip could take, and which of the two bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_call(n0: int, n1: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one top-2 match of n0 valid query rows against
    n1 valid train rows of depth d: float32-grade products as three TF32
    products (3 x 2 x n0 x n1 x d); each descriptor read once, the train
    mask read once, (best, second, index) written once per query."""
    flops = 3.0 * 2.0 * n0 * n1 * d
    nbytes = 4.0 * d * (n0 + n1) + n1 + 12.0 * n0
    return flops, nbytes


def k2_call(levels: int, rows: int, cols: int, windows: int, py: int, px: int) -> float:
    """Bytes of one window gather: the (levels, rows, cols) int32 field read
    once, three int32 origins read and one (py, px) int32 window written
    per valid keypoint."""
    return 4.0 * levels * rows * cols + windows * (12.0 + 4.0 * py * px)


# --- K2's launches per frame (copy of frontend/sift.py's patch_launches) ---
_ORI_SAMPLES = 16


def _patch_margin(cfg: dict) -> int:
    S = cfg["sift_scales_per_octave"]
    sigma_max = cfg["sift_sigma"] * 2.0 ** ((S + 0.5) / S)
    desc_off = (2.0**0.5) * 1.875 * 3.0 * sigma_max
    lin_max = (_ORI_SAMPLES - 1) / _ORI_SAMPLES
    ori_off = 2.5 * 1.5 * sigma_max * lin_max
    return int(math.ceil(max(desc_off, ori_off)))


def _patch_size(cfg: dict) -> int:
    return -(-(2 * (_patch_margin(cfg) + 1)) // 8) * 8


def _padded_width(W_o: int, P: int) -> int:
    return max(-(-W_o // 128) * 128, ((P + 127) // 128) * 128 + 128)


def _patch_fits(H_o: int, budget: int, P: int) -> bool:
    return -(-H_o // 8) * 8 >= P + 8 and budget % 8 == 0


def padded_keypoints(cfg: dict) -> int:
    return -(-max(cfg["max_keypoints"], cfg["sift_n_features"]) // 128) * 128


def octave_budgets(total: int, num_octaves: int) -> list[int]:
    budgets, remaining = [], total
    for o in range(num_octaves):
        if o == num_octaves - 1:
            budgets.append(remaining)
        else:
            b = max(total // (2 ** (o + 1)), 1)
            budgets.append(b)
            remaining -= b
    return budgets


def k2_launches(cfg: dict) -> list[tuple[int, int, int, int, int, int, int]]:
    """(octave, levels, padded rows, padded columns, slots, window rows,
    window columns) of each K2 launch a SIFT frame makes on CUDA."""
    if cfg["extractor_type"] != "sift" or cfg["sift_sampling"] not in ("auto", "patch"):
        return []
    budgets = octave_budgets(padded_keypoints(cfg) // cfg["sift_orientation_peaks"],
                             cfg["sift_num_octaves"])
    P = _patch_size(cfg)
    W_o, H_o = cfg["image_size"]
    if cfg["sift_first_octave"] == -1:
        W_o, H_o = 2 * W_o, 2 * H_o
    out = []
    for o in range(cfg["sift_num_octaves"]):
        if _patch_fits(H_o, budgets[o], P):
            out.append((o, cfg["sift_scales_per_octave"] + 3, -(-H_o // 8) * 8,
                        _padded_width(W_o, P), budgets[o], P + 8, P))
        H_o, W_o = -(-H_o // 2), -(-W_o // 2)
    return out


def octave_slices(cfg: dict) -> list[tuple[int, int]]:
    """[start, end) of each octave's slots in a SIFT frame's Features (one
    orientation peak: octaves in order, each its budget)."""
    budgets = octave_budgets(padded_keypoints(cfg), cfg["sift_num_octaves"])
    starts = [sum(budgets[:o]) for o in range(len(budgets))]
    return [(s, s + b) for s, b in zip(starts, budgets)]


# --- the SuperPoint network (dense head) ---
# (Cin, Cout, kernel, downsampling of the layer's grid) of each convolution
SUPERPOINT_DENSE = (
    (1, 64, 3, 1), (64, 64, 3, 1),  # conv1a, conv1b
    (64, 64, 3, 2), (64, 64, 3, 2),  # conv2a, conv2b
    (64, 128, 3, 4), (128, 128, 3, 4),  # conv3a, conv3b
    (128, 128, 3, 8), (128, 128, 3, 8),  # conv4a, conv4b
    (128, 256, 3, 8), (256, 256, 1, 8),  # convDa, convDb
    (64, 8, 1, 1), (64, 8, 1, 2), (128, 8, 1, 4), (128, 8, 1, 8),  # score1-4
    (32, 16, 3, 1), (16, 1, 3, 1),  # scoreMixA, scoreMixB
)


def padded_frame(image_size) -> tuple[int, int]:
    """(H, W) of a frame padded to multiples of 8, as the network sees it."""
    W, H = image_size
    return -(-H // 8) * 8, -(-W // 8) * 8


def superpoint_dense_flops(H: int, W: int) -> float:
    """Multiply-adds x 2 of the dense SuperPoint's convolutions on one
    (H, W) frame, H and W multiples of 8 (bias, pooling, upsampling and
    normalisation are left out: under 1% of the total)."""
    return sum(2.0 * ci * co * k * k * (H // s) * (W // s) for ci, co, k, s in SUPERPOINT_DENSE)
