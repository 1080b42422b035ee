#!/usr/bin/env python
"""Train the dense-scoring-head SuperPoint with the PyTorch port, on CUDA.

The port of scripts/train_superpoint_dense.py, the recipe of the bundled
`superpoint_dense.pkl`: warm-starts the shared encoder and descriptor head
from `superpoint_vo.pkl` (or, given a third argument, a whole dense
checkpoint) and trains with the NMS-aware loss of
models/train_superpoint_dense.py at 320x640, batch 8, VO pairs and
homography pairs alternating over the SIFT-teacher pool, Adam with a
cosine decay from `lr` to 5% of it. Batches are made on a producer thread
while the card steps.

Usage: python scripts/train_torch_superpoint_dense.py [steps] [out.pkl]
         [warm_dense.pkl] [loc_w] [lr]

The pool is cached in `.sp_vo_pool_v2_torch.npz` and the weights go to
`.weights_torch/superpoint_dense.pkl` by default (both git-ignored), in the
JAX trainers' pickle layout, which both packages read.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

POOL = os.path.join(ROOT, ".sp_vo_pool_v2_torch.npz")
OUT = os.path.join(ROOT, ".weights_torch", "superpoint_dense.pkl")
HW, BATCH = (320, 640), 8


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 6000
    out = sys.argv[2] if len(sys.argv) > 2 else OUT
    warm_dense = sys.argv[3] if len(sys.argv) > 3 else None
    loc_w = float(sys.argv[4]) if len(sys.argv) > 4 else 4.0
    lr = float(sys.argv[5]) if len(sys.argv) > 5 else 2e-4

    import torch

    from visualodometry_tpu_torch import resolve_device
    from visualodometry_tpu_torch.data.prefetch import PrefetchLoader
    from visualodometry_tpu_torch.frontend.superpoint import load_superpoint
    from visualodometry_tpu_torch.models import weights
    from visualodometry_tpu_torch.models.optim import Adam, cosine_decay_schedule
    from visualodometry_tpu_torch.models.train_superpoint import load_params, save_params
    from visualodometry_tpu_torch.models.train_superpoint_dense import (
        make_train_step_dense,
        recipe_batch,
        warm_start_dense,
    )
    from visualodometry_tpu_torch.models.vo_distill import build_vo_pool

    dev = resolve_device(None)
    print("building/loading VO pool...", flush=True)
    pool = build_vo_pool(np.random.default_rng(4), n_scenes=16, frames_per_scene=8,
                         cache=POOL, device=dev)
    print(f"pool: {len(pool['imgs'])} frames, "
          f"label density {(pool['labels'] != 64).mean():.3f}", flush=True)

    if warm_dense:
        model = load_superpoint(weights_path=warm_dense)[0].to(dev)
        print(f"warm start (full dense): {warm_dense}", flush=True)
    else:
        warm = weights.bundled("superpoint_vo.pkl")
        model = warm_start_dense(torch.Generator().manual_seed(0), load_params(warm),
                                 input_hw=HW, device=dev)
        print(f"warm start (encoder+desc): {warm}", flush=True)
    opt = Adam(model.parameters(), cosine_decay_schedule(lr, steps, alpha=0.05))
    train_step = make_train_step_dense(model, opt, loc_w=loc_w)

    prng = np.random.default_rng(5)
    batches = PrefetchLoader(range(steps), depth=4,
                             decode=lambda i: recipe_batch(prng, pool, i, steps, BATCH, HW))
    t0 = time.perf_counter()
    for i, b in enumerate(batches):
        loss, aux = train_step(b)
        if i % 250 == 0 or i == steps - 1:
            print(f"step {i}: loss {loss.item():.4f} det {aux[0].item():.4f} "
                  f"loc {aux[1].item():.4f} desc {aux[2].item():.4f} "
                  f"({(i + 1) / (time.perf_counter() - t0):.2f} steps/s)", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params(model, out)
    print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()
