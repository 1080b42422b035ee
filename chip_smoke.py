#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and hold its kernels.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):
  1. the card's name and power limit; build every CUDA kernel from
     `visualodometry_tpu_torch/csrc/` (one nvcc per source, in parallel);
  2. K1 (top-2 matcher) against its plain PyTorch version at 4096 x 4096 x
     128, unit descriptors, ~10% invalid train rows, a duplicated train row
     in two different splits of the train set; again at a ragged 4001 x 4059;
     and, after the main path has run, on the SIFT descriptors of fixture
     frames 0 and 1, where the Lowe-ratio masks through the kernel and
     through the plain version must agree outside a 1e-5 band at the
     threshold;
  3. K2 (patch gather) against its plain version, bit-equal, at the three
     octave shapes of the 1226 x 370 main path and the four of the
     KITTI-gates path (first octave -1); a call must not synchronise;
  4. K3 (blur stack) against its plain version, max abs error <= 1e-5 on
     inputs in [0, 1], at every shape the KITTI-gates path launches (B = 8;
     C = 5 at 740x2452, 370x1226, 185x613, 93x307; C = 1 at 740x2452), at
     47x154 and C = 1 at 370x1226 (first octave 0), at a ragged 70x130, and
     B = 1 against B = 8 bit-equal per frame;
  5. per kernel: max error, kernel / plain / library times (CUDA events
     around a batch of calls queued behind a spin kernel, so they are device
     times and not the host's launch times; median of three batches), the
     bound, and the launches; K3's times are
     one chunk's five launches of the KITTI-gates path summed and divided
     by 8 (a frame's share), each launch also on a line of its own with the
     kernel build it ran (specialised or generic), its bound and its share
     of the bound, and the band-matmul pyramid's time at the same shapes on
     a line of its own;
  6. the main path at the bench configuration (4096 slots, 3 octaves,
     256 + 256 RANSAC hypotheses, 20480-slot map) on the 32-frame textured
     fixture in 4 chunks of 8, through `make_chunked_pipeline_fn`: every
     kernel launch count is zeroed before the pass and read after it;
     resets == 0, keyframes >= 28, sim3 ATE (frames 8:) <= 0.05 m,
     K1 x 32, K2 x 96 and K3 x 0 launches; then a second, timed pass;
  7. the KITTI-gates path: `get_config("kitti", "sift")` (P3P, 40-px
     keyframe gate, 1-px PnP gate, 4 octaves) with the renderer-matched
     edge threshold, global scale 2.4 and the upsampled -1 octave, on 192
     marathon-fixture frames with a blackout at 120-123, in 24 chunks of
     8 with `pyramid_impl="pallas"`: counts zeroed before and read after
     (K1 x 192, K2 x 768, K3 x 120), finite poses, a reset inside
     [120, 183), tracking at the end with keyframes after the reset;
  8. the same frames with `pyramid_impl="auto"` (band matmul, K3 x 0): the
     tracking A/B of the two pyramid routes, with its limits on resets
     outside the explained window (GATES_UNEXPLAINED_*);
  9. `VOEngine` per frame on the first 16 frames of the 32-frame fixture,
     with a save_state / load_state round trip at frame 8;
 10. the SuperPoint path: `get_config("kitti", "superpoint")` with
     bench.py:_build_superpoint_cfg's overrides (2048 slots, P3P, the dense
     SuperPoint weights, bf16 network, Lowe 0.92) on the same 32 frames in
     4 chunks of 8: counts zeroed before and read after (K1 x 32, K2 x 0,
     K3 x 0), resets == 0, sim3 ATE (frames 8:) <= 0.10 m, keyframes at
     least the JAX package's CPU count less 3 (scripts/learned_jax_cpu.py);
     the device busy times (profiler) of the network (B = 8), of keypoint
     selection and of the matcher, the step's wall time, and a second,
     timed pass;
 11. the attention path: BENCH_CFG with the attention matcher (the v2
     weights, `adaptive_match` with pruning to 1024 and exit at 0.95, bf16):
     K2 x 96, K1 x 0, K3 x 0, resets == 0, sim3 ATE <= 0.05 m, keyframes as
     above; the same times (SIFT extraction in place of network and
     selection);
 12. `VOEngine` with SuperPoint on the first 16 frames: no reset, finite
     positions.
K1 is also held against its plain version at the SuperPoint path's shape,
2048 x 2048 x 256, and timed there, on a log line of its own (phase 2).

The last two lines are the kernel table as one JSON object and the
contract line {"ok": true, "device": {...}}. Exits non-zero without a CUDA
device, and when the package is not beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # TF32 on the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

# bench.py:_build_cfg, the main path's operating point
BENCH_CFG = dict(
    extractor_type="sift",
    max_keypoints=4096,
    sift_n_features=4096,
    sift_contrast_threshold=0.02,
    sift_num_octaves=3,
    min_median_flow=3.0,
    max_reproj_err=2.0,
    pnp_reproj_err=2.0,
    min_depth=1.0,
    min_parallax_deg=0.35,
    lowe_ratio=0.8,
    essential_hypotheses=256,
    pnp_hypotheses=256,
    map_capacity=20480,
    matcher_backend="pallas",
)
IMG_SIZE = (1226, 370)
CHUNK = 8
N_FRAMES = 32
# (L, H_pad, W_pad, K) of the packed gradient fields at 1226 x 370
PATCH_SHAPES = ((6, 376, 1280, 2048), (6, 192, 640, 1024), (6, 96, 384, 1024))
# the same for the KITTI-gates path (first octave -1, 4 octaves)
GATES_PATCH_SHAPES = (
    (6, 744, 2560, 2048), (6, 376, 1280, 1024), (6, 192, 640, 512), (6, 96, 384, 512),
)
PATCH_Y, PATCH_X = 72, 64

# the KITTI-gates path: overrides on get_config("kitti", "sift"), and frames
GATES_OVERRIDES = dict(
    sift_edge_threshold=10.0,  # renderer-matched detection floor
    global_scale=2.4,
    matcher_backend="pallas",
    sift_first_octave=-1,
)
GATES_FRAMES = 192
GATES_BLANK = (120, 123)
GATES_EXPLAINED = 60  # frames after a blackout in which a reset is explained
# (C, H, W) of K3's launches in one chunk of that path, B = CHUNK each
GATES_BLUR_SHAPES = ((1, 740, 2452), (5, 740, 2452), (5, 370, 1226), (5, 185, 613),
                     (5, 93, 307))
# parity only: first octave 0's fourth octave and base, and a ragged tile
EXTRA_BLUR_SHAPES = ((5, 47, 154), (1, 370, 1226), (5, 70, 130))
SIFT_SIGMA, SIFT_SCALES = 1.6, 3
# Limits of the pyramid-route A/B on resets outside the explained window.
# The JAX package on the CPU over the same frames gives 0 (its default
# band-matmul pyramid; scripts/kitti_gates_jax_cpu.py), so the band-matmul
# pass is held to 0. The blur-stack pass may do no worse than that pass
# plus 1: one marginal DoG extremum flipping into one reset over 192
# frames is within what a summation order can do; more is a finding.
GATES_UNEXPLAINED_MATMUL = 0
GATES_UNEXPLAINED_K3_MARGIN = 1

# the learned paths: bench.py:_build_superpoint_cfg's overrides on
# get_config("kitti", "superpoint") (the port's matcher is K1 on CUDA
# whatever matcher_backend says), and BENCH_CFG with the attention matcher
SP_OVERRIDES = dict(
    min_median_flow=3.0,
    max_reproj_err=2.0,
    pnp_reproj_err=2.0,
    min_depth=1.0,
    lowe_ratio=0.92,
    min_parallax_deg=0.35,
    matcher_backend="jnp",
)
# Limits. ATE: the JAX reference's TPU records are 0.027 m (SuperPoint) and
# 0.012 m (attention) (BENCH_r05.json); tracking failures show as
# metre-class ATE. Keyframes: the JAX package on the CPU over the same
# frames (scripts/learned_jax_cpu.py) less LEARNED_KF_MARGIN, for gate
# flags that flip at marginal flows.
SP_ATE_LIMIT = 0.10
AT_ATE_LIMIT = 0.05
SP_JAX_CPU_KEYFRAMES = 31
AT_JAX_CPU_KEYFRAMES = 31
LEARNED_KF_MARGIN = 3
K1_SP_SHAPE = (2048, 2048, 256)


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


_SPIN_CYCLES_PER_MS = None


def time_ms(torch, fn, reps: int = 25, warmup: int = 3, batches: int = 3) -> float:
    """Median device time of one call of `fn`, in milliseconds.

    `reps` calls are queued behind a spin kernel that keeps the card busy
    while the host enqueues them, and two CUDA events bracket the batch: the
    calls then run back to back, and the reading is the device's time, not
    the host's time to launch (which is several times longer for the small
    kernels). The spin is sized from the measured enqueue time of a batch.
    A batch must stay under the card's queue of pending launches (about a
    thousand): beyond it the host waits for the spin and the reading becomes
    the host's time; `busy_ms` measures the stages of many launches.
    """
    global _SPIN_CYCLES_PER_MS
    if _SPIN_CYCLES_PER_MS is None:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(20_000_000)
        b.record()
        b.synchronize()
        _SPIN_CYCLES_PER_MS = 20_000_000 / a.elapsed_time(b)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((1.5 * enqueue_ms + 0.5) * _SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def union_us(ranges) -> float:
    """Total length of the union of [start, end) intervals (microseconds)."""
    total = 0.0
    end_max = None
    for s, e in sorted(ranges):
        if end_max is None or s > end_max:
            total += e - s
            end_max = e
        elif e > end_max:
            total += e - end_max
            end_max = e
    return total


def busy_ms(torch, fn) -> float:
    """Device busy time of one call of `fn`, in milliseconds: the union of
    its kernels' intervals under torch.profiler, after one warm-up call.

    For stages of hundreds to thousands of small launches, where `time_ms`
    cannot hold its batch behind the spin: the card's launch queue fills
    after about a thousand launches, the host then waits for the spin, and
    the reading becomes the host's time. Gaps between kernels are not
    counted, so this is the device's own time and no more."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    check(len(kernels) > 0, "the profiler recorded no device time")
    return union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3


def _k1_parity(torch, m, d0, d1, valid1, what: str, abs_limit: float | None = None) -> float:
    """Hold K1 against its plain version on these inputs; returns the largest
    absolute error. Relative 1e-5 on best and second: both sum 128 products in
    float32 in different orders (the plain version itself sits 4e-6 from a
    float64 reference at these sizes); the argbest must agree wherever the
    plain version's top two are 1e-4 apart. With `abs_limit`, the distances
    are held to that absolute error instead: where best distances are near
    zero, |a|^2 + |b|^2 - 2 a.b cancels and no float32 evaluation of it is
    good to 1e-5 of the difference (the plain version's own relative error
    against float64 is printed beside the kernel's)."""
    b_k, s_k, i_k = m.match_top2(d0, d1, valid1)
    b_p, s_p, i_p = m._top2_torch(d0, d1, valid1)
    b_r, s_r, _ = m._top2_torch(d0.double(), d1.double(), valid1)
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.double() - b.double()).abs() / b.double().abs().clamp(min=1e-6)).max().item()

    rel_b, rel_s = rel(b_k, b_p), rel(s_k, s_p)
    err = max((b_k - b_p).abs().max().item(), (s_k - s_p).abs().max().item())
    sep = (s_p - b_p) > 1e-4
    idx_ok = bool(torch.equal(i_k[sep], i_p[sep]))
    log(f"K1 parity, {what}: best rel {rel_b:.3e}, second rel {rel_s:.3e}, argbest equal on "
        f"{int(sep.sum())}/{d0.shape[0]} separated rows: {idx_ok}, max abs err {err:.3e}; "
        f"against float64: kernel "
        f"{rel(b_k, b_r):.3e} / {rel(s_k, s_r):.3e}, plain version {rel(b_p, b_r):.3e} / "
        f"{rel(s_p, s_r):.3e}")
    if abs_limit is None:
        check(rel_b <= 1e-5 and rel_s <= 1e-5,
              f"K1 distances disagree with the plain version ({what})")
    else:
        check(err <= abs_limit, f"K1 distances disagree with the plain version ({what})")
    check(idx_ok, f"K1 argbest disagrees with the plain version ({what})")
    ok_rows = b_k < 1e29
    check(not bool(valid1[i_k[ok_rows].long()].logical_not().any()),
          f"K1 matched an invalid row ({what})")
    return err


def phase_match(torch, dev, card):
    from visualodometry_tpu_torch.ops import match_top2 as m

    g = torch.Generator(device=dev).manual_seed(0)
    n0 = n1 = 4096
    d = 128
    d0 = torch.randn(n0, d, generator=g, device=dev)
    d1 = torch.randn(n1, d, generator=g, device=dev)
    d0 /= d0.norm(dim=1, keepdim=True)
    d1 /= d1.norm(dim=1, keepdim=True)
    # plant near-duplicates so the ratio test has real matches
    d1[:2048] = d0[:2048] + 0.05 * torch.randn(2048, d, generator=g, device=dev)
    d1 /= d1.norm(dim=1, keepdim=True)
    valid1 = torch.rand(n1, generator=g, device=dev) >= 0.1
    err = _k1_parity(torch, m, d0, d1, valid1, f"{n0} x {n1} x {d} unit vectors")

    # the train set is split across blocks: the same row in two splits must
    # give the lower index, with the copy's equal distance as the second
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = m._splits(n0, n1, sms)
    lo, hi = 100, n1 - 200
    check(splits >= 2 and lo // (n1 // splits) != hi // (n1 // splits),
          "the duplicate rows do not lie in different splits")
    d1t, v1t = d1.clone(), valid1.clone()
    d1t[lo] = d1t[hi] = d0[3000]
    v1t[lo] = v1t[hi] = True
    b_k, s_k, i_k = m.match_top2(d0, d1t, v1t)
    torch.cuda.synchronize()
    log(f"K1 tie across splits ({splits} splits): argbest {int(i_k[3000])} (want {lo}), "
        f"best {float(b_k[3000]):.3e}, second {float(s_k[3000]):.3e}")
    check(int(i_k[3000]) == lo and float(s_k[3000]) == float(b_k[3000]),
          "K1 tie across splits: not the lower index with second == best")
    # a ragged train set whose last tile and last split are short (without
    # the exact copies: a relative error means nothing at distance zero)
    cut = n1 - 37
    err = max(err, _k1_parity(torch, m, d0[:4001], d1[:cut], valid1[:cut],
                              f"4001 x {cut} x {d}, ragged"))

    _k1_superpoint_shape(torch, m, dev, card)

    def library():
        dist = torch.cdist(d0, d1)
        d2 = (dist * dist).masked_fill(~valid1[None, :], 1e30)
        return torch.topk(d2, 2, dim=1, largest=False)

    t_k = time_ms(torch, lambda: m.match_top2(d0, d1, valid1))
    t_p = time_ms(torch, lambda: m._top2_torch(d0, d1, valid1))
    t_l = time_ms(torch, library)
    # the work the kernel does: three TF32 products per float32 product,
    # on the tensor cores; its bytes include the splits' partial results,
    # written once and read once by the merge
    flops = 2.0 * n0 * n1 * d
    nbytes = (n0 + n1) * d * 4 + n1 + n0 * 12 + 2 * splits * n0 * 12
    t_ops = 3.0 * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return dict(
        name="match_top2", route="cuda",
        source="visualodometry_tpu_torch/csrc/match_top2.cu",
        replaces="visualodometry_tpu/ops/match_pallas.py:101",
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=t_l,
        # which peak the bound is taken at, and the float32 CUDA-core bound
        # of one product per element that earlier readings were held to
        bound_peak="tensor operations: 3 TF32 products per float32 product at 495 TFLOP/s",
        bound_f32_cores_ms=flops / PEAK_F32_FLOPS * 1e3,
    )


def _k1_superpoint_shape(torch, m, dev, card):
    """K1 at the SuperPoint path's shape: parity (as at 128-D), device time,
    and its bound, on a log line of its own."""
    n0, n1, d = K1_SP_SHAPE
    g = torch.Generator(device=dev).manual_seed(3)
    d0 = torch.randn(n0, d, generator=g, device=dev)
    d1 = torch.randn(n1, d, generator=g, device=dev)
    d0 /= d0.norm(dim=1, keepdim=True)
    d1 /= d1.norm(dim=1, keepdim=True)
    # near-duplicates at the 128-D case's distances, so the ratio test has
    # real matches and no distance sits near zero
    d1[: n1 // 2] = d0[: n1 // 2] + 0.05 * torch.randn(n1 // 2, d, generator=g, device=dev)
    d1 /= d1.norm(dim=1, keepdim=True)
    valid1 = torch.rand(n1, generator=g, device=dev) >= 0.1
    err = _k1_parity(torch, m, d0, d1, valid1, f"{n0} x {n1} x {d} unit vectors")
    t_k = time_ms(torch, lambda: m.match_top2(d0, d1, valid1))
    t_p = time_ms(torch, lambda: m._top2_torch(d0, d1, valid1))
    splits = m._splits(n0, n1, torch.cuda.get_device_properties(dev).multi_processor_count)
    t_ops = 3.0 * 2.0 * n0 * n1 * d / PEAK_TF32_FLOPS
    t_bytes = ((n0 + n1) * d * 4 + n1 + n0 * 12 + 2 * splits * n0 * 12) / PEAK_BYTES
    b = max(t_ops, t_bytes) * 1e3
    log(f"K1 at the SuperPoint path's shape {n0} x {n1} x {d}: max abs err {err:.3e}, "
        f"kernel_ms {t_k:.4f}, plain_ms {t_p:.4f}, bound_ms {b:.4f} "
        f"({'operations' if t_ops > t_bytes else 'bytes'}, 3 TF32 products per float32 "
        f"product), {b / t_k:.1%} of the bound, {splits} splits, on {card}")


def phase_match_real(torch, dev, u8):
    """K1 on SIFT descriptors (non-negative, clipped at 0.2, many near-ties
    among non-matches): fixture frames 0 and 1 at the bench configuration,
    and the Lowe-ratio mask through the kernel and the plain version."""
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.frontend import matcher
    from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn
    from visualodometry_tpu_torch.ops import match_top2 as m

    cfg = config_from_dict(BENCH_CFG)
    f0, f1 = make_batched_extract_fn(cfg, device=dev)(torch.as_tensor(u8[:2]).to(dev))
    log(f"fixture frames 0 and 1: {int(f0.valid.sum())} and {int(f1.valid.sum())} live "
        f"descriptors of {f0.desc.shape[0]} slots, depth {f0.desc.shape[1]}")
    # 4e-6 is 1e-6 of |a|^2 + |b|^2 + 2 |a.b| = 4 for near-equal unit
    # vectors, the sizes of the terms that cancel; 1e-5 relative allows
    # 2.4e-6 at the synthetic matches' distance of 0.24
    _k1_parity(torch, m, f0.desc, f1.desc, f1.valid, "SIFT descriptors of frames 0 and 1",
               abs_limit=4e-6)
    ratio = BENCH_CFG["lowe_ratio"]
    with_kernel = matcher.match_descriptors(f0.desc, f0.valid, f1.desc, f1.valid, ratio=ratio)
    kernel_top2 = matcher.match_top2
    matcher.match_top2 = m._top2_torch
    try:
        with_plain = matcher.match_descriptors(f0.desc, f0.valid, f1.desc, f1.valid, ratio=ratio)
    finally:
        matcher.match_top2 = kernel_top2
    b_p, s_p, _ = m._top2_torch(f0.desc, f1.desc, f1.valid)
    band = ((b_p / s_p.clamp(min=1e-30) - ratio * ratio).abs() <= 1e-5) & f0.valid
    differ = with_kernel.valid != with_plain.valid
    agree_idx = bool(torch.equal(with_kernel.idx[with_plain.valid & ~band],
                                 with_plain.idx[with_plain.valid & ~band]))
    log(f"Lowe ratio {ratio}: {int(with_plain.valid.sum())} matches through the plain version, "
        f"{int(with_kernel.valid.sum())} through K1; masks differ on {int(differ.sum())} rows, "
        f"{int((differ & ~band).sum())} of them outside the band |best/second - "
        f"{ratio * ratio:.2f}| <= 1e-5, which holds {int(band.sum())} rows; matched indices "
        f"equal: {agree_idx}")
    check(not bool((differ & ~band).any()), "K1 flips a ratio test outside the 1e-5 band")
    check(agree_idx, "K1 matches other train rows than the plain version")


def phase_patches(torch, dev):
    from visualodometry_tpu_torch.ops import patches as p

    g = torch.Generator(device=dev).manual_seed(1)
    t_k = t_p = t_l = 0.0
    nbytes = 0
    for L, H, W, K in PATCH_SHAPES + GATES_PATCH_SHAPES:
        field = torch.randint(
            -(2**31), 2**31 - 1, (L, H, W), generator=g, device=dev, dtype=torch.int64
        ).to(torch.int32)
        lvl = torch.randint(0, L, (K,), generator=g, device=dev).to(torch.int32)
        y0 = torch.randint(0, H - PATCH_Y + 1, (K,), generator=g, device=dev).to(torch.int32)
        x0 = torch.randint(0, W - PATCH_X + 1, (K,), generator=g, device=dev).to(torch.int32)
        out_k = p.extract_patches(field, lvl, y0, x0, PATCH_Y, PATCH_X)
        out_p = p._extract_patches_torch(field, lvl, y0, x0, PATCH_Y, PATCH_X)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out_k, out_p))
        log(f"K2 parity at field {(L, H, W)}, K={K}: bit-equal {equal}")
        check(equal, f"K2 disagrees with the plain version at {(L, H, W)}")
        # encoding the tensor map is host arithmetic: a call must not wait
        torch.cuda.set_sync_debug_mode("error")
        try:
            p.extract_patches(field, lvl, y0, x0, PATCH_Y, PATCH_X, check_bounds=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if (L, H, W, K) not in PATCH_SHAPES:
            continue  # times are the main path's frame: its three shapes
        iy = torch.arange(PATCH_Y, device=dev)
        ix = torch.arange(PATCH_X, device=dev)
        li, yi, xi = lvl.long(), y0.long(), x0.long()

        def library():
            return field[li[:, None, None], yi[:, None, None] + iy[None, :, None],
                         xi[:, None, None] + ix[None, None, :]]

        t_k += time_ms(torch, lambda: p.extract_patches(
            field, lvl, y0, x0, PATCH_Y, PATCH_X, check_bounds=False))
        t_p += time_ms(torch, lambda: p._extract_patches_torch(
            field, lvl, y0, x0, PATCH_Y, PATCH_X))
        t_l += time_ms(torch, library)
        nbytes += field.numel() * 4 + 3 * K * 4 + K * PATCH_Y * PATCH_X * 4
    b_ms, b_by = bound_ms(0.0, nbytes)
    return dict(
        name="extract_patches", route="cuda",
        source="visualodometry_tpu_torch/csrc/patches.cu",
        replaces="visualodometry_tpu/ops/patches.py:139",
        max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_l,
    )


def _base_sigma(H: int) -> float:
    """The base pre-blur's sigma: the upsampled 740-row base assumes twice
    the sensor blur of the 370-row one."""
    return (SIFT_SIGMA**2 - (1.0 if H == 2 * IMG_SIZE[1] else 0.5) ** 2) ** 0.5


def _blur_taps(C: int, H: int):
    """The taps the pyramid gives K3: the octave stack (C = 5) or the base
    pre-blur (C = 1)."""
    import math

    from visualodometry_tpu_torch.ops import pyramid as p

    if C > 1:
        return p._stack_taps(SIFT_SCALES, SIFT_SIGMA)
    sig = _base_sigma(H)
    return (tuple(p._full_kernel_np(sig, max(1, math.ceil(3.0 * sig))).tolist()),)


def phase_blur(torch, dev, card):
    import torch.nn.functional as F

    from visualodometry_tpu_torch.ops import pyramid as p

    g = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    t_k = t_p = t_l = t_m = 0.0
    t_ops = t_bytes = b_ms = 0.0
    for C, H, W in GATES_BLUR_SHAPES + EXTRA_BLUR_SHAPES:
        B = CHUNK
        img = torch.rand(B, H, W, generator=g, device=dev)
        taps = _blur_taps(C, H)
        tap_t = torch.tensor(taps, device=dev)
        out_k = p.blur_stack(img, taps)
        out_p = p._blur_stack_torch(img, tap_t)
        one = p.blur_stack(img[3], taps)
        torch.cuda.synchronize()
        e = float((out_k - out_p).abs().max())
        same = bool(torch.equal(one, out_k[3]))
        log(f"K3 parity at B={B}, C={C}, {H}x{W}, {len(taps[0])} taps: max abs err "
            f"{e:.3e}, B=1 bit-equal to B=8: {same}")
        check(out_k.shape == (B, C, H, W), "K3 output shape")
        check(e <= 1e-5, f"K3 disagrees with the plain version at C={C}, {H}x{W}: {e:.3e}")
        check(same, f"K3 depends on the batch at C={C}, {H}x{W}")
        err = max(err, e)
        if (C, H, W) not in GATES_BLUR_SHAPES:
            continue  # times are one chunk of the KITTI-gates path
        T = len(taps[0])
        R = (T - 1) // 2
        w_h = tap_t.reshape(C, 1, 1, T)
        w_v = tap_t.reshape(C, 1, T, 1)

        def library():
            x = F.pad(img[:, None], (R, R, R, R), mode="replicate")
            return F.conv2d(F.conv2d(x, w_h), w_v, groups=C)

        def band_matmul():
            if C == 1:
                return p.blur_2d(img, _base_sigma(H))[:, None]
            return p.build_gaussian_octave(img, SIFT_SIGMA, SIFT_SCALES)[:, 1:]

        check(float((library() - out_p).abs().max()) <= 1e-4, "K3 library yardstick is off")
        check(float((band_matmul() - out_p).abs().max()) <= 1e-4,
              "band-matmul yardstick is off")
        launch_ms = time_ms(torch, lambda: p.blur_stack(img, taps))
        t_k += launch_ms
        t_p += time_ms(torch, lambda: p._blur_stack_torch(img, tap_t), reps=7, warmup=1)
        t_l += time_ms(torch, library, reps=11, warmup=2)
        t_m += time_ms(torch, band_matmul, reps=11, warmup=2)
        flops = 2.0 * 2.0 * T * C * B * H * W
        nbytes = 4.0 * B * H * W * (1 + C)
        t_ops += flops / PEAK_F32_FLOPS
        t_bytes += nbytes / PEAK_BYTES
        launch_bound, launch_by = bound_ms(flops, nbytes)
        b_ms += launch_bound
        log(f"K3 launch (C, H, W, T) = {(C, H, W, T)}, B={B}, {p.blur_stack_instantiation(taps)} "
            f"instantiation: {launch_ms:.4f} ms, bound {launch_bound:.4f} ms ({launch_by}), "
            f"{launch_bound / launch_ms:.1%} of the bound, on {card}")
        del out_k, out_p, img
    log(f"band-matmul pyramid at K3's shapes (blur_2d + build_gaussian_octave, what "
        f"pyramid_impl='auto' runs instead): {t_m / CHUNK:.4f} ms/frame on {card}")
    return dict(
        name="blur_stack", route="cuda",
        source="visualodometry_tpu_torch/csrc/blur_stack.cu",
        replaces="visualodometry_tpu/ops/pyramid.py:301",
        max_abs_err=err, ms=t_k / CHUNK, plain_ms=t_p / CHUNK, bound_ms=b_ms / CHUNK,
        bound_by="operations" if t_ops > t_bytes else "bytes", library_ms=t_l / CHUNK,
    )


def phase_main_path(torch, dev, card):
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn
    from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
    from visualodometry_tpu_torch.eval import ate_rmse
    t0 = time.perf_counter()
    scene = make_scene(
        np.random.default_rng(7), num_frames=N_FRAMES, speed=1.2,
        turn_rate=0.002, image_size=IMG_SIZE,
    )
    u8 = render_fixture_u8(scene)
    log(f"fixture: {u8.shape} uint8 rendered in {time.perf_counter() - t0:.1f} s")
    cfg = config_from_dict(BENCH_CFG)
    chunks = [torch.as_tensor(u8[i : i + CHUNK]).to(dev) for i in range(0, N_FRAMES, CHUNK)]

    def run_pass():
        run = make_chunked_pipeline_fn(cfg, scene.K, device=dev)
        state = init_state(cfg, desc_dim=128, device=dev)
        outs = []
        for c in chunks:
            state, out = run(state, c)
            outs.append(out)
        torch.cuda.synchronize()
        return outs

    zero_launches()
    t0 = time.perf_counter()
    outs = run_pass()
    first_s = time.perf_counter() - t0
    launches = read_launches()

    est = torch.cat([o.T_wc for o in outs])[:, :3, 3].cpu().numpy()
    resets = int(sum(int(o.did_reset.sum()) for o in outs))
    keyframes = int(sum(int(o.is_keyframe.sum()) for o in outs))
    ate = float(ate_rmse(est[8:], scene.gt_positions[8 : len(est)], align="sim3"))
    check(bool(np.isfinite(est).all()), "main path produced non-finite poses")
    log(f"main path: {N_FRAMES} frames, resets {resets}, keyframes {keyframes}, "
        f"sim3 ATE {ate:.6f} m, launches {launches}, first pass {first_s:.2f} s")
    check(resets == 0, f"main path reset {resets} times")
    check(keyframes >= 28, f"main path made only {keyframes} keyframes")
    check(ate <= 0.05, f"main path sim3 ATE {ate:.4f} m > 0.05 m")
    check(launches["match_top2"] == 32, f"K1 launched {launches['match_top2']} times, not 32")
    check(launches["extract_patches"] == 96,
          f"K2 launched {launches['extract_patches']} times, not 96")
    check(launches["blur_stack"] == 0, "the main path's pyramid is the band matmul")

    t0 = time.perf_counter()
    run_pass()
    dt = time.perf_counter() - t0
    log(f"main path second pass: {N_FRAMES / dt:.3f} frames/s ({dt:.3f} s for "
        f"{N_FRAMES} frames) on {card}")
    return launches, scene, u8


def gates_config():
    from visualodometry_tpu_torch import get_config

    return get_config("kitti", extractor="sift").replace(**GATES_OVERRIDES)


def phase_gates(torch, dev, card, fixture, pyramid_impl: str):
    """One pass over the KITTI-gates frames; returns (launches, summary)."""
    from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn
    from visualodometry_tpu_torch.data.synthetic import segment_ate

    u8, gt, K = fixture
    n = len(u8)
    cfg = gates_config()
    chunks = [torch.as_tensor(u8[i : i + CHUNK]).to(dev) for i in range(0, n, CHUNK)]
    run = make_chunked_pipeline_fn(cfg, K, device=dev, pyramid_impl=pyramid_impl)
    state = init_state(cfg, desc_dim=128, device=dev)
    outs = []
    zero_launches()
    t0 = time.perf_counter()
    for c in chunks:
        state, out = run(state, c)
        outs.append(out)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()

    T = torch.cat([o.T_wc for o in outs]).cpu().numpy()
    resets = torch.cat([o.did_reset for o in outs]).cpu().numpy()
    kf = torch.cat([o.is_keyframe for o in outs]).cpu().numpy()
    inited = torch.cat([o.initialized for o in outs]).cpu().numpy()
    reset_frames = np.flatnonzero(resets)
    lo, hi = GATES_BLANK[0], min(GATES_BLANK[1] + GATES_EXPLAINED, n)
    explained = (reset_frames >= lo) & (reset_frames < hi)
    segs = segment_ate(T[:, :3, 3], gt, resets)
    seg_max = max((a for _, _, a in segs), default=float("nan"))
    kf_after = int(kf[reset_frames[-1] :].sum()) if len(reset_frames) else int(kf.sum())
    summary = dict(
        resets=int(resets.sum()), unexplained=int((~explained).sum()),
        explained=int(explained.sum()), keyframes=int(kf.sum()),
        keyframes_after_reset=kf_after, tracking=bool(inited[-1]), segment_ate_max=seg_max,
    )
    log(f"KITTI-gates path, pyramid_impl={pyramid_impl!r}: {n} frames, resets "
        f"{summary['resets']} at {reset_frames.tolist()}, outside the explained window "
        f"[{lo}, {hi}): {summary['unexplained']}, keyframes {summary['keyframes']} "
        f"({kf_after} after the last reset), tracking at the end {summary['tracking']}, "
        f"largest segment ATE {seg_max:.4f} m over {len(segs)} segments, launches "
        f"{launches}, {n / dt:.3f} frames/s first pass ({dt:.1f} s) on {card}")
    check(bool(np.isfinite(T).all()), "KITTI-gates path produced non-finite poses")
    check(summary["explained"] >= 1, "no reset inside the explained window: the "
          "blackout did not drive the reset branch")
    check(summary["tracking"], "KITTI-gates path is not tracking on the last frame")
    check(kf_after > 0, "no keyframe after the reset: re-bootstrap failed")
    check(launches["match_top2"] == n, f"K1 launched {launches['match_top2']} times, not {n}")
    # K2: once per frame for each of the 4 octaves (all fit the patch path)
    check(launches["extract_patches"] == 4 * n,
          f"K2 launched {launches['extract_patches']} times, not {4 * n}")
    want_k3 = (1 + 4) * len(chunks) if pyramid_impl == "pallas" else 0
    check(launches["blur_stack"] == want_k3,
          f"K3 launched {launches['blur_stack']} times, not {want_k3}")
    return launches, summary


def phase_engine(torch, dev, scene, u8, tmp_dir):
    """`VOEngine` per frame, with a checkpoint round trip at frame 8."""
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.core import VOEngine

    cfg = config_from_dict(BENCH_CFG)
    frames = u8[:16]
    whole = VOEngine(scene.K, cfg, device=dev)
    outs = [whole.process_frame(img) for img in frames]
    first = VOEngine(scene.K, cfg, device=dev)
    for img in frames[:8]:
        first.process_frame(img)
    path = os.path.join(tmp_dir, "engine_state.npz")
    first.save_state(path)
    resumed = VOEngine(scene.K, cfg, device=dev)
    resumed.load_state(path)
    for img in frames[8:]:
        resumed.process_frame(img)
    os.remove(path)
    keyframes = sum(bool(o.is_keyframe) for o in outs)
    a, b = whole.positions()[8:], resumed.positions()
    length = float(np.linalg.norm(np.diff(a, axis=0), axis=1).sum())
    diff = float(np.abs(a - b).max())
    log(f"VOEngine: 16 frames, keyframes {keyframes}, resets "
        f"{sum(bool(o.did_reset) for o in outs)}; resumed from a checkpoint at frame 8: "
        f"max position difference {diff:.3e} over a path of {length:.3f} "
        f"({100 * diff / length:.4f}%)")
    check(a.shape == b.shape == (8, 3) and bool(np.isfinite(b).all()), "VOEngine positions")
    check(keyframes >= 12, f"VOEngine made only {keyframes} keyframes")
    # runs of the same code differ on the card at the 1e-4 level of the
    # path (scatter and top-k tie order); 1% would be a different track
    check(diff <= 0.01 * length, f"resumed engine left the uninterrupted track: {diff}")


def superpoint_config():
    from visualodometry_tpu_torch import get_config

    return get_config("kitti", extractor="superpoint").replace(**SP_OVERRIDES)


def attention_config():
    from visualodometry_tpu_torch import config_from_dict

    return config_from_dict(BENCH_CFG).replace(matcher_type="attention")


def phase_learned(torch, dev, card, scene, u8, name: str):
    """One learned path on the 32-frame fixture: tracking, launches, times."""
    from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn
    from visualodometry_tpu_torch.eval import ate_rmse
    from visualodometry_tpu_torch.frontend.superpoint import _pad_to_multiple
    from visualodometry_tpu_torch.models.superpoint import select_keypoints, superpoint_heads

    sp = name == "superpoint"
    cfg = superpoint_config() if sp else attention_config()
    desc_dim = 256 if sp else 128
    chunks = [torch.as_tensor(u8[i : i + CHUNK]).to(dev) for i in range(0, N_FRAMES, CHUNK)]

    def run_pass():
        run = make_chunked_pipeline_fn(cfg, scene.K, device=dev)
        state = init_state(cfg, desc_dim=desc_dim, device=dev)
        outs = []
        for c in chunks:
            state, out = run(state, c)
            outs.append(out)
        torch.cuda.synchronize()
        return run, state, outs

    zero_launches()
    t0 = time.perf_counter()
    run, state, outs = run_pass()
    first_s = time.perf_counter() - t0
    launches = read_launches()
    est = torch.cat([o.T_wc for o in outs])[:, :3, 3].cpu().numpy()
    resets = int(sum(int(o.did_reset.sum()) for o in outs))
    keyframes = int(sum(int(o.is_keyframe.sum()) for o in outs))
    ate = float(ate_rmse(est[8:], scene.gt_positions[8 : len(est)], align="sim3"))
    log(f"{name} path: {N_FRAMES} frames, {cfg.padded_keypoints} slots, resets {resets}, "
        f"keyframes {keyframes}, sim3 ATE {ate:.6f} m, launches {launches}, first pass "
        f"{first_s:.2f} s")
    ate_limit = SP_ATE_LIMIT if sp else AT_ATE_LIMIT
    jax_kf = SP_JAX_CPU_KEYFRAMES if sp else AT_JAX_CPU_KEYFRAMES
    check(bool(np.isfinite(est).all()), f"{name} path produced non-finite poses")
    check(resets == 0, f"{name} path reset {resets} times")
    check(ate <= ate_limit, f"{name} path sim3 ATE {ate:.4f} m > {ate_limit} m")
    check(keyframes >= jax_kf - LEARNED_KF_MARGIN,
          f"{name} path made {keyframes} keyframes; the JAX package makes {jax_kf}")
    want = ({"match_top2": N_FRAMES, "extract_patches": 0, "blur_stack": 0} if sp
            else {"match_top2": 0, "extract_patches": 3 * N_FRAMES, "blur_stack": 0})
    check(launches == want, f"{name} path launched {launches}, not {want}")

    # device busy time of the stages on the first chunk, a frame's share
    feats = run.extract(chunks[0])
    if sp:
        model, thr = run.extract.model, run.extract.threshold
        x = _pad_to_multiple(chunks[0].float() * (1.0 / 255.0))
        with torch.no_grad():
            heat, desc = superpoint_heads(model, x)
            t_net = busy_ms(torch, lambda: superpoint_heads(model, x))
            t_sel = busy_ms(torch, lambda: [
                select_keypoints(heat[i], desc[i], cfg.padded_keypoints, thr)
                for i in range(CHUNK)])
        stages = (f"network (B={CHUNK}, bf16) {t_net / CHUNK:.4f} ms/frame, keypoint "
                  f"selection {t_sel / CHUNK:.4f} ms/frame")
    else:
        t_ext = busy_ms(torch, lambda: run.extract(chunks[0]))
        stages = f"SIFT extraction {t_ext / CHUNK:.4f} ms/frame"
    t_match = busy_ms(torch, lambda: run.step.match(state.keyframe, feats[1]))
    # the VO step alone, host clock over the 32 frames (it reads branch
    # scalars back, so it cannot be queued behind a spin)
    all_feats = [f for c in chunks for f in run.extract(c)]
    st = init_state(cfg, desc_dim=desc_dim, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in all_feats:
        st, _ = run.step(st, f)
    torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    del all_feats, st

    t0 = time.perf_counter()
    run_pass()
    dt = time.perf_counter() - t0
    log(f"{name} path device busy times: {stages}, matcher {t_match:.4f} ms/frame; VO step "
        f"alone {t_step:.2f} ms/frame (wall); second pass {N_FRAMES / dt:.3f} frames/s "
        f"({dt:.3f} s for {N_FRAMES} frames); on {card}")


def phase_engine_superpoint(torch, dev, scene, u8):
    """`VOEngine` with the SuperPoint extractor, per frame, first 16 frames."""
    from visualodometry_tpu_torch.core import VOEngine

    engine = VOEngine(scene.K, superpoint_config(), device=dev)
    outs = [engine.process_frame(img) for img in u8[:16]]
    pos = engine.positions()
    resets = sum(bool(o.did_reset) for o in outs)
    log(f"VOEngine with SuperPoint: 16 frames, desc_dim {engine.desc_dim}, keyframes "
        f"{sum(bool(o.is_keyframe) for o in outs)}, resets {resets}, tracking "
        f"{bool(outs[-1].initialized)}")
    check(resets == 0, f"VOEngine with SuperPoint reset {resets} times")
    check(pos.shape == (16, 3) and bool(np.isfinite(pos).all()),
          "VOEngine with SuperPoint: positions")


def zero_launches():
    from visualodometry_tpu_torch.ops import match_top2, patches, pyramid

    match_top2.launches = patches.launches = pyramid.launches = 0


def read_launches() -> dict:
    from visualodometry_tpu_torch.ops import match_top2, patches, pyramid

    return {"match_top2": match_top2.launches, "extract_patches": patches.launches,
            "blur_stack": pyramid.launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import visualodometry_tpu_torch  # noqa: F401  (fails outside a checkout)
    from visualodometry_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    from visualodometry_tpu_torch.data.synthetic import make_marathon_fixture

    kernels = [phase_match(torch, dev, smi), phase_patches(torch, dev),
               phase_blur(torch, dev, smi)]
    launches, scene, u8 = phase_main_path(torch, dev, smi)
    phase_match_real(torch, dev, u8)
    phase_engine(torch, dev, scene, u8, os.environ.get("TMPDIR", "/tmp"))
    phase_learned(torch, dev, smi, scene, u8, "superpoint")
    phase_learned(torch, dev, smi, scene, u8, "attention")
    phase_engine_superpoint(torch, dev, scene, u8)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    g_u8, g_gt, g_K, _ = make_marathon_fixture(num_frames=GATES_FRAMES, blanks=(GATES_BLANK,))
    log(f"KITTI-gates fixture: {g_u8.shape} uint8 rendered in {time.perf_counter() - t0:.1f} s")
    launches_k3, with_k3 = phase_gates(torch, dev, smi, (g_u8, g_gt, g_K), "pallas")
    _, with_matmul = phase_gates(torch, dev, smi, (g_u8, g_gt, g_K), "auto")
    check(with_matmul["unexplained"] <= GATES_UNEXPLAINED_MATMUL,
          f"band-matmul pass: {with_matmul['unexplained']} resets outside the window")
    check(with_k3["unexplained"] <= with_matmul["unexplained"] + GATES_UNEXPLAINED_K3_MARGIN,
          f"blur-stack pass: {with_k3['unexplained']} resets outside the window against "
          f"{with_matmul['unexplained']} with the band matmul")
    # K1 and K2 report the 32-frame main path's counts, K3 its own path's
    launches["blur_stack"] = launches_k3["blur_stack"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        log(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, kernel_ms {k['ms']:.4f}, "
            f"plain_ms {k['plain_ms']:.4f}, library_ms {k['library_ms']:.4f}, "
            f"bound_ms {k['bound_ms']:.4f} ({k['bound_by']}), "
            f"launches {k['launches']} on {smi}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_peak",
            "bound_f32_cores_ms")
    log(json.dumps({"kernels": [{key: k[key] for key in keys if key in k} for k in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
