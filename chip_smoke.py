#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and hold its kernels.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):
  1. the card's name and power limit; build every CUDA kernel from
     `visualodometry_tpu_torch/csrc/` (one nvcc per source, in parallel);
  2. K1 (top-2 matcher) against its plain PyTorch version at 4096 x 4096 x
     128, unit descriptors, ~10% invalid train rows;
  3. K2 (patch gather) against its plain version at the three octave
     shapes of the 1226 x 370 main path, bit-equal;
  4. per kernel: max error, kernel / plain / library times (CUDA events,
     median of 25 runs after warm-up), the bound, and the launches;
  5. the main path at the bench configuration (4096 slots, 3 octaves,
     256 + 256 RANSAC hypotheses, 20480-slot map) on the 32-frame textured
     fixture in 4 chunks of 8, through `make_chunked_pipeline_fn`: every
     kernel launch count is zeroed before the pass and read after it;
     resets == 0, keyframes >= 28, sim3 ATE (frames 8:) <= 0.05 m,
     K1 x 32 and K2 x 96 launches; then a second, timed pass.

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
PATCH_Y, PATCH_X = 72, 64


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of `fn`, in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_match(torch, dev):
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

    b_k, s_k, i_k = m.match_top2(d0, d1, valid1)
    b_p, s_p, i_p = m._top2_torch(d0, d1, valid1)
    torch.cuda.synchronize()
    rel_b = ((b_k - b_p).abs() / b_p.abs().clamp(min=1e-6)).max().item()
    rel_s = ((s_k - s_p).abs() / s_p.abs().clamp(min=1e-6)).max().item()
    err = max((b_k - b_p).abs().max().item(), (s_k - s_p).abs().max().item())
    sep = (s_p - b_p) > 1e-4
    idx_ok = bool(torch.equal(i_k[sep], i_p[sep]))
    log(f"K1 parity: best rel {rel_b:.3e}, second rel {rel_s:.3e}, "
        f"argbest equal on {int(sep.sum())}/{n0} separated rows: {idx_ok}")
    check(rel_b <= 1e-5 and rel_s <= 1e-5, "K1 distances disagree with the plain version")
    check(idx_ok, "K1 argbest disagrees with the plain version")
    check(not bool(valid1[i_k.long()].logical_not().any()), "K1 matched an invalid row")

    def library():
        dist = torch.cdist(d0, d1)
        d2 = (dist * dist).masked_fill(~valid1[None, :], 1e30)
        return torch.topk(d2, 2, dim=1, largest=False)

    t_k = time_ms(torch, lambda: m.match_top2(d0, d1, valid1))
    t_p = time_ms(torch, lambda: m._top2_torch(d0, d1, valid1))
    t_l = time_ms(torch, library)
    flops = 2.0 * n0 * n1 * d
    nbytes = (n0 + n1) * d * 4 + n1 + n0 * 12
    b_ms, b_by = bound_ms(flops, nbytes)
    return dict(
        name="match_top2", route="cuda",
        source="visualodometry_tpu_torch/csrc/match_top2.cu",
        replaces="visualodometry_tpu/ops/match_pallas.py:101",
        max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
        library_ms=t_l,
    )


def phase_patches(torch, dev):
    from visualodometry_tpu_torch.ops import patches as p

    g = torch.Generator(device=dev).manual_seed(1)
    t_k = t_p = t_l = 0.0
    nbytes = 0
    for L, H, W, K in PATCH_SHAPES:
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


def phase_main_path(torch, dev, card):
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn
    from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
    from visualodometry_tpu_torch.eval import ate_rmse
    from visualodometry_tpu_torch.ops import match_top2, patches

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

    match_top2.launches = 0
    patches.launches = 0
    t0 = time.perf_counter()
    outs = run_pass()
    first_s = time.perf_counter() - t0
    launches = {"match_top2": match_top2.launches, "extract_patches": patches.launches}

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

    t0 = time.perf_counter()
    run_pass()
    dt = time.perf_counter() - t0
    log(f"main path second pass: {N_FRAMES / dt:.3f} frames/s ({dt:.3f} s for "
        f"{N_FRAMES} frames) on {card}")
    return launches


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

    kernels = [phase_match(torch, dev), phase_patches(torch, dev)]
    launches = phase_main_path(torch, dev, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        log(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, kernel_ms {k['ms']:.4f}, "
            f"plain_ms {k['plain_ms']:.4f}, library_ms {k['library_ms']:.4f}, "
            f"bound_ms {k['bound_ms']:.4f} ({k['bound_by']}), "
            f"launches {k['launches']} on {smi}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
