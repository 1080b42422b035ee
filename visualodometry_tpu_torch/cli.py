"""Command-line entry point: dataset -> decode/prefetch -> engine -> metrics.

Port of visualodometry_tpu/cli.py, with the same flags and output. It
mirrors the reference CLI surface (reference: src/main.py:19-30: dataset
in {kitti, malaga, parking, own}, --path, --sequence) and adds an explicit
--extractor, --tracker, --ba / --smooth, headless mode and ATE against the
loaded ground truth. Three modes:

- per frame (default): `VOEngine` over `PrefetchLoader`;
- chunked (`--chunk C`): native batch decode, a uint8 upload, and
  `make_chunked_pipeline_fn` (with `--ba`, the in-loop windowed BA);
- KLT (`--tracker klt`): SIFT detections and the KLT step frame by frame.

Runs on CUDA unless `--platform cpu` is given; without a CUDA device the
default raises. The last line of stdout is one JSON object,
{"frames": N, "fps": F, "ate_xz_sim3": A}, with `ate_xz_sim3` only when
there is ground truth and at least 8 positions.

    python -m visualodometry_tpu_torch.cli --dataset kitti --path data --chunk 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Monocular VO on PyTorch/CUDA")
    p.add_argument(
        "--dataset",
        choices=["kitti", "malaga", "parking", "own"],
        default="kitti",
    )
    p.add_argument("--path", type=Path, default=Path("data"))
    p.add_argument("--sequence", type=str, default="05")
    p.add_argument("--extractor", choices=["sift", "superpoint"], default="sift")
    p.add_argument(
        "--tracker",
        choices=["descriptor", "klt"],
        default="descriptor",
        help="correspondence engine: descriptor matching (reference "
        "semantics) or KLT candidate tracking",
    )
    p.add_argument("--ba", action="store_true", help="enable windowed BA")
    p.add_argument(
        "--smooth",
        action="store_true",
        help="loop-free pose-graph smoothing over the keyframe chain "
        "before evaluation (per-frame engine; pairs with --ba, whose "
        "refined window edges the smoother fuses)",
    )
    p.add_argument("--viz", action="store_true", help="spawn rerun viewer")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--prefetch-depth", type=int, default=4)
    p.add_argument(
        "--max-keypoints",
        type=int,
        default=0,
        help="override the keypoint slot count (0 = per-dataset default)",
    )
    p.add_argument(
        "--chunk",
        type=int,
        default=0,
        help="frames per device dispatch (0 = per-frame engine; chunked "
        "mode uses the chunk runner + native batch decode, no viz)",
    )
    p.add_argument(
        "--platform",
        choices=["default", "cpu"],
        default="default",
        help="'default' runs on CUDA and fails without a CUDA device; 'cpu' "
        "runs the plain PyTorch versions of the kernels on the host",
    )
    p.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override any VOConfig field after the per-dataset defaults "
        "(repeatable), e.g. --set min_median_flow=3 --set "
        "sift_num_octaves=3. The per-dataset gates are tuned for the "
        "real datasets; synthetic fixtures need scene-matched gates.",
    )
    return p


def _apply_overrides(cfg, pairs: list[str]):
    """Apply --set KEY=VALUE pairs, coercing to the field's current type."""
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if not _ or not hasattr(cfg, key):
            raise SystemExit(f"--set: unknown config field {key!r}")
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        else:
            val = raw
        cfg = cfg.replace(**{key: val})
    return cfg


def resolve_config(args):
    """The run's VOConfig: the dataset's defaults for the extractor, then
    --max-keypoints, then the --set overrides in order."""
    from visualodometry_tpu_torch.config import get_config

    cfg = get_config(args.dataset, extractor=args.extractor)
    if args.max_keypoints > 0:
        cfg = cfg.replace(
            max_keypoints=args.max_keypoints,
            sift_n_features=args.max_keypoints,
        )
    return _apply_overrides(cfg, args.overrides)


def _report(frames: int, dt: float, est: np.ndarray, ground_truth) -> int:
    """Print the result line: frames, frames/s and the xz sim3 ATE."""
    from visualodometry_tpu_torch.eval import ate_rmse

    result = {"frames": int(frames), "fps": round(frames / max(dt, 1e-9), 2)}
    if ground_truth is not None and len(est) >= 8:
        gt = ground_truth[: len(est)]
        n = min(len(gt), len(est))
        result["ate_xz_sim3"] = round(ate_rmse(est[:n, [0, 2]], gt[:n], align="sim3"), 3)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from visualodometry_tpu_torch._device import resolve_device
    from visualodometry_tpu_torch.data.loaders import make_dataset

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    loader = make_dataset(args.dataset, args.path, sequence=args.sequence)
    if not loader.image_files:
        print(f"Error: no images found under {args.path}", file=sys.stderr)
        return 1
    print(f"Loaded {len(loader.image_files)} images; K=\n{loader.K}")
    cfg = resolve_config(args)

    if args.tracker == "klt":
        return _run_klt(args, loader, cfg, device)
    if args.chunk > 0:
        return _run_chunked(args, loader, cfg, device)
    return _run_engine(args, loader, cfg, device)


def _run_engine(args, loader, cfg, device) -> int:
    """Per-frame engine over the prefetching loader."""
    from visualodometry_tpu_torch.core.pipeline import VOEngine
    from visualodometry_tpu_torch.data.prefetch import PrefetchLoader

    viz = None
    if args.viz:
        from visualodometry_tpu_torch.viz.rerun_sink import RerunSink

        viz = RerunSink()
    engine = VOEngine(K=loader.K, cfg=cfg, enable_ba=args.ba, viz=viz, device=device)

    paths = loader.image_files[: args.max_frames]
    t0 = time.perf_counter()
    for i, img in enumerate(PrefetchLoader(paths, depth=args.prefetch_depth)):
        out = engine.process_frame(img)
        if i % 50 == 0:
            print(
                f"frame {i}: init={bool(out.initialized)} "
                f"tracked={int(out.num_tracked)} pos={np.round(out.T_wc[:3, 3], 1)}"
            )
    dt = time.perf_counter() - t0
    return _report(len(paths), dt, engine.positions(smoothed=args.smooth), loader.ground_truth)


def _run_chunked(args, loader, cfg, device) -> int:
    """Native batch decode + the chunk runner; frames past the last whole
    chunk are dropped (fixed shapes, as the JAX CLI)."""
    import torch

    from visualodometry_tpu_torch.core.runner import make_chunked_pipeline_fn
    from visualodometry_tpu_torch.core.state import init_state
    from visualodometry_tpu_torch.data import native_decode

    paths = loader.image_files[: args.max_frames]
    w, h = native_decode.image_info(paths[0])
    run = make_chunked_pipeline_fn(
        cfg, loader.K.astype(np.float32), device=device, enable_ba=args.ba
    )
    carry = init_state(cfg, desc_dim=256 if args.extractor == "superpoint" else 128, device=device)
    if args.ba:
        from visualodometry_tpu_torch.ba.inloop import init_window

        carry = (carry, init_window(cfg, device=device))

    C = args.chunk
    positions = []
    t0 = time.perf_counter()
    n_full = len(paths) - len(paths) % C
    for i in range(0, n_full, C):
        frames, n_ok = native_decode.decode_batch(paths[i : i + C], w, h)
        if n_ok != C:
            raise RuntimeError(
                f"decoded {n_ok} of the {C} frames from {paths[i]}: each must be "
                f"a {w}x{h} PNG, PGM or baseline JPEG"
            )
        # uint8 upload: 4x fewer host->device bytes; normalized on device
        u8 = (np.clip(frames, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        carry, out = run(carry, torch.from_numpy(u8).to(device))
        positions.append(out.T_wc[:, :3, 3])
    est = torch.cat(positions).cpu().numpy() if positions else np.zeros((0, 3))
    dt = time.perf_counter() - t0
    return _report(n_full, dt, est, loader.ground_truth)


def _run_klt(args, loader, cfg, device) -> int:
    """KLT candidate-tracking mode (core/klt_step.py), frame by frame."""
    import torch

    from visualodometry_tpu_torch.core.klt_step import init_klt_state, make_klt_step_fn
    from visualodometry_tpu_torch.data import native_decode
    from visualodometry_tpu_torch.data.prefetch import PrefetchLoader
    from visualodometry_tpu_torch.frontend.sift import extract_sift

    paths = loader.image_files[: args.max_frames]
    w, h = native_decode.image_info(paths[0])
    step = make_klt_step_fn(cfg, loader.K.astype(np.float32), (h, w), device=device)
    state = init_klt_state(cfg, (h, w), device=device)

    positions = []
    t0 = time.perf_counter()
    for i, img in enumerate(PrefetchLoader(paths, depth=args.prefetch_depth)):
        imgt = torch.from_numpy(img).to(device)
        feats = extract_sift(imgt, cfg, device=device)
        state, out = step(state, imgt, feats)
        positions.append(out.T_wc[:3, 3])
        if i % 50 == 0:
            print(
                f"frame {i}: init={bool(out.initialized)} "
                f"tracked={int(out.num_tracked)} "
                f"landmarks={int(out.num_landmarks)}"
            )
    est = torch.stack(positions).cpu().numpy() if positions else np.zeros((0, 3))
    dt = time.perf_counter() - t0
    return _report(len(paths), dt, est, loader.ground_truth)


if __name__ == "__main__":
    raise SystemExit(main())
