#!/usr/bin/env python
"""Train the attention matcher on real SIFT descriptors with the PyTorch port.

The port of scripts/train_matcher_real.py, the recipe of the bundled
`attention_matcher_sift.pkl`: a depth-4 matcher with shared heads
(warm-started from `attention_matcher_synthetic.pkl` when present),
`matcher_loss` on batches of 16 homography problems at 512 slots, Adam with
a linear decay from 2e-4 to 2e-5; then held-out precision and recall
against mutual-NN + ratio 0.8 on the same problems (K1 on the card).

Usage: python scripts/train_torch_matcher_real.py [steps] [n_pairs] [out.pkl]

The dataset is cached in `.matcher_dataset_sift_torch.npz`, the weights go
to `.weights_torch/attention_matcher_sift.pkl` by default (git-ignored).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CACHE = os.path.join(ROOT, ".matcher_dataset_sift_torch.npz")
OUT = os.path.join(ROOT, ".weights_torch", "attention_matcher_sift.pkl")


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    n_pairs = int(sys.argv[2]) if len(sys.argv) > 2 else 384
    out = sys.argv[3] if len(sys.argv) > 3 else OUT

    import torch

    from visualodometry_tpu_torch import resolve_device
    from visualodometry_tpu_torch.frontend.matcher import match_descriptors
    from visualodometry_tpu_torch.models import convert, weights
    from visualodometry_tpu_torch.models.attention_matcher import AttentionMatcher
    from visualodometry_tpu_torch.models.matcher_data import (
        as_match_batch,
        build_sift_match_dataset,
        held_out_split,
        load_or_build,
        sample_batch,
    )
    from visualodometry_tpu_torch.models.optim import Adam, linear_schedule
    from visualodometry_tpu_torch.models.train_matcher import evaluate, make_matcher_step
    from visualodometry_tpu_torch.models.train_superpoint import load_params, save_params

    dev = resolve_device(None)
    data = load_or_build(CACHE, lambda: build_sift_match_dataset(
        np.random.default_rng(11), n_pairs=n_pairs, device=dev))
    print(f"gt match rate per slot: {(data['gt_idx'] >= 0).mean():.3f}", flush=True)
    train, test = held_out_split(data)

    model = AttentionMatcher(desc_dim=128, depth=4)
    warm = weights.bundled("attention_matcher_synthetic.pkl")
    if warm.exists():
        model.load_state_dict(convert.attention_state_dict_from_flax(load_params(warm)))
        print("warm-started from synthetic weights", flush=True)
    else:
        model.init_identity_residual(torch.Generator().manual_seed(0))
    model = model.to(dev)
    step = make_matcher_step(model, Adam(model.parameters(), linear_schedule(2e-4, 2e-5, steps)))

    rng = np.random.default_rng(0)
    for i in range(steps):
        loss = step(sample_batch(train, rng, 16))
        if i % 200 == 0 or i == steps - 1:
            print(f"step {i}: loss {loss.item():.4f}", flush=True)

    p, r = evaluate(model, as_match_batch(test))
    print(f"attention matcher held-out: precision {p:.3f} recall {r:.3f}")

    # mutual-NN + ratio baseline on the same problems, all pairs in one call
    t = {k: torch.as_tensor(v, device=dev) for k, v in test.items()}
    res = match_descriptors(t["desc0"], t["valid0"], t["desc1"], t["valid1"],
                            ratio=0.8, mutual=True)
    idx, ok, gt = res.idx.cpu().numpy(), res.valid.cpu().numpy(), test["gt_idx"]
    tp, fp, fn = ((gt == idx) & ok).sum(), ((gt != idx) & ok).sum(), ((gt >= 0) & ~ok).sum()
    print(f"mutual-NN ratio baseline: precision {tp / max(tp + fp, 1):.3f} "
          f"recall {tp / max(tp + fn, 1):.3f}")

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params(model, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
