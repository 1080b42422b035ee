#!/usr/bin/env python
"""Train the v2 adaptive attention matcher with the PyTorch port, on CUDA.

The port of scripts/train_matcher_v2.py, the recipe of the bundled
`attention_matcher_sift_v2.pkl`: warm-starts every shared tensor from the
shared-head `attention_matcher_sift.pkl`, initialises each earlier layer's
similarity and matchability heads from its final heads, and trains with
`matcher_loss_deep` (batches of 8 homography problems, Adam with a cosine
decay from 2e-4). Then held-out precision and recall of the full-depth
forward and of `adaptive_match` without pruning, pruning to half the
slots, and pruning with the exit at 0.9.

Usage: python scripts/train_torch_matcher_v2.py [steps] [out.pkl]

The dataset is cached in `.matcher_dataset_sift_torch.npz`, the weights go
to `.weights_torch/attention_matcher_sift_v2.pkl` by default (git-ignored).
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CACHE = os.path.join(ROOT, ".matcher_dataset_sift_torch.npz")
OUT = os.path.join(ROOT, ".weights_torch", "attention_matcher_sift_v2.pkl")
DEPTH = 4


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 4000
    out = sys.argv[2] if len(sys.argv) > 2 else OUT

    import torch

    from visualodometry_tpu_torch import resolve_device
    from visualodometry_tpu_torch.models import convert, weights
    from visualodometry_tpu_torch.models.attention_matcher import AttentionMatcher
    from visualodometry_tpu_torch.models.matcher_data import (
        build_sift_match_dataset,
        held_out_split,
        load_or_build,
        sample_batch,
    )
    from visualodometry_tpu_torch.models.optim import Adam, cosine_decay_schedule
    from visualodometry_tpu_torch.models.train_matcher import (
        evaluate,
        evaluate_adaptive,
        make_matcher_step,
    )
    from visualodometry_tpu_torch.models.train_superpoint import load_params, save_params

    dev = resolve_device(None)
    data = load_or_build(CACHE, lambda: build_sift_match_dataset(
        np.random.default_rng(11), n_pairs=384, device=dev))
    train, test = held_out_split(data)

    model = AttentionMatcher(desc_dim=128, depth=DEPTH, per_layer_heads=True)
    model.init_identity_residual(torch.Generator().manual_seed(0))
    old = weights.bundled("attention_matcher_sift.pkl")
    if old.exists():
        shared = convert.attention_state_dict_from_flax(load_params(old))
        state = model.state_dict()
        for k, v in shared.items():
            head = k.split(".")[0] in ("out_projs", "match_heads")
            # the old model's one head is every layer's head here
            for key in ([k.replace(".0.", f".{i}.", 1) for i in range(DEPTH)] if head else [k]):
                state[key] = v
        model.load_state_dict(state)
        print("warm-started from the shared-head checkpoint", flush=True)
    model = model.to(dev)
    step = make_matcher_step(
        model, Adam(model.parameters(), cosine_decay_schedule(2e-4, steps, alpha=0.05)),
        deep=True)

    rng = np.random.default_rng(1)
    for i in range(steps):
        loss = step(sample_batch(train, rng, 8))
        if i % 200 == 0 or i == steps - 1:
            print(f"step {i}: loss {loss.item():.4f}", flush=True)

    # held-out eval: full depth vs adaptive inference
    tb = sample_batch(test, rng, len(test["kps0"]))
    prec, rec = evaluate(model, tb)
    print(f"held-out FULL: precision {prec:.3f} recall {rec:.3f}", flush=True)
    held = {k: v.numpy() for k, v in tb._asdict().items()}
    n_slots = held["kps0"].shape[1]
    for prune, ec in ((0, 0.0), (n_slots // 2, 0.0), (n_slots // 2, 0.9)):
        prec, rec = evaluate_adaptive(model, held, prune_to=prune, exit_conf=ec)
        print(f"held-out ADAPTIVE prune={prune} exit={ec}: precision {prec:.3f} "
              f"recall {rec:.3f}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params(model, out)
    print(f"saved {out}", flush=True)


if __name__ == "__main__":
    main()
