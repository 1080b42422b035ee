#!/usr/bin/env python
"""SuperPoint VO-stage finetune with the PyTorch port, on CUDA.

The port of scripts/train_superpoint_r4.py, the recipe of the bundled
`superpoint_vo.pkl`: continues from `superpoint_textured.pkl` with the
distillation loss (`vo_distill.loss_fn_sub`, descriptor weight 2, subpixel
weight 0.5) at 320x640, batch 8, VO pairs and homography pairs alternating
over the SIFT-teacher pool, Adam with a cosine decay from 1.5e-4.

Usage: python scripts/train_torch_superpoint_r4.py [steps] [out.pkl] [warm.pkl]

The pool is cached in `.sp_vo_pool_v2_torch.npz` and the weights go to
`.weights_torch/superpoint_vo.pkl` by default (both git-ignored).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

POOL = os.path.join(ROOT, ".sp_vo_pool_v2_torch.npz")
OUT = os.path.join(ROOT, ".weights_torch", "superpoint_vo.pkl")
HW, BATCH = (320, 640), 8


def main():
    from visualodometry_tpu_torch.models import weights

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 6000
    out = sys.argv[2] if len(sys.argv) > 2 else OUT
    warm = sys.argv[3] if len(sys.argv) > 3 else str(weights.bundled("superpoint_textured.pkl"))

    from visualodometry_tpu_torch import resolve_device
    from visualodometry_tpu_torch.data.prefetch import PrefetchLoader
    from visualodometry_tpu_torch.frontend.superpoint import load_superpoint
    from visualodometry_tpu_torch.models.optim import Adam, cosine_decay_schedule
    from visualodometry_tpu_torch.models.train_superpoint import (
        make_step,
        save_params,
    )
    from visualodometry_tpu_torch.models.train_superpoint_dense import recipe_batch
    from visualodometry_tpu_torch.models.vo_distill import build_vo_pool, loss_fn_sub

    dev = resolve_device(None)
    print("building/loading VO pool...", flush=True)
    pool = build_vo_pool(np.random.default_rng(4), n_scenes=16, frames_per_scene=8,
                         cache=POOL, device=dev)
    print(f"pool: {len(pool['imgs'])} frames, "
          f"label density {(pool['labels'] != 64).mean():.3f}", flush=True)
    model = load_superpoint(weights_path=warm)[0].to(dev)
    print(f"warm start: {warm}", flush=True)
    opt = Adam(model.parameters(), cosine_decay_schedule(1.5e-4, steps, alpha=0.05))
    train_step = make_step(model, opt, lambda m, b: loss_fn_sub(m, b, desc_w=2.0, sub_w=0.5))

    prng = np.random.default_rng(5)
    batches = PrefetchLoader(range(steps), depth=4,
                             decode=lambda i: recipe_batch(prng, pool, i, steps, BATCH, HW))
    for i, b in enumerate(batches):
        loss, aux = train_step(b)
        if i % 250 == 0 or i == steps - 1:
            print(f"step {i}: loss {loss.item():.4f} det {aux[0].item():.4f} "
                  f"desc {aux[1].item():.4f} sub {aux[2].item():.4f}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params(model, out)
    print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()
