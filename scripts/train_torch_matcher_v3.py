#!/usr/bin/env python
"""Train the v3 attention matcher with the PyTorch port, on CUDA.

The port of scripts/train_matcher_v3.py: depth 4, dim 256, per-layer
heads, `matcher_loss_deep`, warm-started from `attention_matcher_sift_v2.pkl`
(identity-residual init when the file is missing). Homography batches of 8
problems at 512 slots (SIFT on textured homography pairs) alternate with VO
batches of 4 full-width KITTI-shape problems cut to 1024 random slots
(SIFT at 4096 slots, depth ground truth), one VO batch every `vo_every`
steps; Adam with a cosine decay from 1e-4 to 5% of it. Then the held-out
problems: `evaluate` on the homography ones and `adaptive_match` (pruning
to 1024, exit at 0.95) on the full 4096-slot VO ones.

Usage: python scripts/train_torch_matcher_v3.py [steps] [out.pkl] [warm.pkl]
         [vo_every] [cache_vo.npz]

The datasets are cached in `.matcher_dataset_sift_torch.npz` and
`.matcher_dataset_vo_torch.npz`, the weights go to
`.weights_torch/attention_matcher_sift_v3.pkl` by default (all git-ignored),
in the JAX trainers' pickle layout.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CACHE_H = os.path.join(ROOT, ".matcher_dataset_sift_torch.npz")
CACHE_VO = os.path.join(ROOT, ".matcher_dataset_vo_torch.npz")
OUT = os.path.join(ROOT, ".weights_torch", "attention_matcher_sift_v3.pkl")


def main():
    from visualodometry_tpu_torch.models import weights

    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 4000
    out = sys.argv[2] if len(sys.argv) > 2 else OUT
    warm = sys.argv[3] if len(sys.argv) > 3 else str(weights.bundled("attention_matcher_sift_v2.pkl"))
    vo_every = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    cache_vo = sys.argv[5] if len(sys.argv) > 5 else CACHE_VO

    import torch

    from visualodometry_tpu_torch import resolve_device
    from visualodometry_tpu_torch.models import convert
    from visualodometry_tpu_torch.models.attention_matcher import AttentionMatcher
    from visualodometry_tpu_torch.models.matcher_data import (
        build_sift_match_dataset,
        build_vo_match_dataset,
        held_out_split,
        load_or_build,
        sample_batch,
        vo_match_batch,
    )
    from visualodometry_tpu_torch.models.optim import Adam, cosine_decay_schedule
    from visualodometry_tpu_torch.models.train_matcher import (
        evaluate,
        evaluate_adaptive,
        make_matcher_step,
    )
    from visualodometry_tpu_torch.models.train_superpoint import load_params, save_params

    dev = resolve_device(None)
    train_h, test_h = held_out_split(load_or_build(CACHE_H, lambda: build_sift_match_dataset(
        np.random.default_rng(11), n_pairs=384, device=dev)))
    train_vo, test_vo = held_out_split(load_or_build(cache_vo, lambda: build_vo_match_dataset(
        np.random.default_rng(12), n_pairs=96, device=dev)))

    model = AttentionMatcher(desc_dim=128, depth=4, per_layer_heads=True)
    if os.path.exists(warm):
        model.load_state_dict(convert.attention_state_dict_from_flax(load_params(warm)))
        print(f"warm-started from {warm}", flush=True)
    else:
        model.init_identity_residual(torch.Generator().manual_seed(0))
    model = model.to(dev)
    step = make_matcher_step(model, Adam(model.parameters(),
                                         cosine_decay_schedule(1e-4, steps, alpha=0.05)),
                             deep=True)

    rng = np.random.default_rng(1)
    for i in range(steps):
        if i % vo_every != vo_every - 1:
            b = sample_batch(train_h, rng, 8)
        else:
            b = vo_match_batch(train_vo, rng, 4, 1024)
        loss = step(b)
        if i % 200 == 0 or i == steps - 1:
            print(f"step {i}: loss {loss.item():.4f}", flush=True)

    prec, rec = evaluate(model, sample_batch(test_h, rng, len(test_h["kps0"])))
    print(f"held-out HOMOG: precision {prec:.3f} recall {rec:.3f}", flush=True)
    prec, rec = evaluate_adaptive(model, test_vo, prune_to=1024, exit_conf=0.95)
    print(f"held-out VO {test_vo['kps0'].shape[1]}-slot ADAPTIVE prune=1024 exit=0.95: "
          f"precision {prec:.3f} recall {rec:.3f}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params(model, out)
    print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()
