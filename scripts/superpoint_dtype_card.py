#!/usr/bin/env python3
"""The SuperPoint path's ATE by network dtype and RANSAC seed, on a card.

Run from the root of a checkout:
    python3 scripts/superpoint_dtype_card.py [--seeds 0 1 2] [--device cuda|cpu]

An experiment without a limit, to tell the two suspects for the SuperPoint
path's ATE apart (bf16 keypoint flips, or the RANSAC draws): chip_smoke.py's
SuperPoint configuration (`superpoint_config()`) on its 32-frame main-path
fixture (1226 x 370, seed 7), the network in bf16 and in float32, the VO
step frame by frame at every seed. Prints one JSON line a run: dtype,
seed, resets, sim3 ATE over frames 8 onward. Tracking outcomes only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from visualodometry_tpu_torch.core import init_state, make_step_fn
    from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
    from visualodometry_tpu_torch.frontend.superpoint import make_batched_superpoint_extract_fn

    dev = torch.device(args.device)
    if dev.type == "cuda":
        from visualodometry_tpu_torch.ops import _build

        _build.build_all()
    scene = make_scene(np.random.default_rng(7), num_frames=cs.N_FRAMES, speed=1.2,
                       turn_rate=0.002, image_size=cs.IMG_SIZE)
    u8 = render_fixture_u8(scene)
    chunks = [torch.as_tensor(u8[i : i + cs.CHUNK]).to(dev)
              for i in range(0, cs.N_FRAMES, cs.CHUNK)]
    for name, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32)):
        cfg0 = cs.superpoint_config()
        extract = make_batched_superpoint_extract_fn(cfg0, device=dev, compute_dtype=dtype)
        feats = [f for c in chunks for f in extract(c)]
        for seed in args.seeds:
            t0 = time.perf_counter()
            cfg = cfg0.replace(seed=seed)
            step = make_step_fn(cfg, scene.K, device=dev)
            state = init_state(cfg, desc_dim=256, device=dev)
            outs = []
            for f in feats:
                state, out = step(state, f)
                outs.append(out)
            est = torch.stack([o.T_wc for o in outs])[:, :3, 3].cpu().numpy()
            print(json.dumps({
                "device": args.device, "dtype": name, "seed": seed,
                "resets": sum(bool(o.did_reset) for o in outs),
                "finite": bool(np.isfinite(est).all()),
                "ate_sim3_m": float(cs._fixture_ate(est, scene.gt_positions)),
                "seconds": round(time.perf_counter() - t0, 1),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
