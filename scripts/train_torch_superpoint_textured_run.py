#!/usr/bin/env python
"""Train SuperPoint on textured homography pairs with the PyTorch port, on CUDA.

The port of scripts/train_superpoint_textured_run.py: warm-starts from the
best bundled checkpoint (`superpoint_textured.pkl`, else
`superpoint_synthetic.pkl`), trains with `pretrain_textured`'s
warp-strength curriculum (with `--corridor`, on crops of pre-rendered
corridor frames) and prints the loss trace.

Usage: python scripts/train_torch_superpoint_textured_run.py \
    [steps] [out.pkl] [HxW] [batch] [--corridor]

The weights go to `.weights_torch/superpoint_textured.pkl` by default
(git-ignored).
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, ".weights_torch", "superpoint_textured.pkl")


def main():
    argv = [a for a in sys.argv[1:] if a != "--corridor"]
    corridor = "--corridor" in sys.argv  # final stage: deployment texture
    steps = int(argv[0]) if len(argv) > 0 else 2000
    out = argv[1] if len(argv) > 1 else OUT
    hw = tuple(int(v) for v in argv[2].split("x")) if len(argv) > 2 else (120, 160)
    batch = int(argv[3]) if len(argv) > 3 else 24

    from visualodometry_tpu_torch import resolve_device
    from visualodometry_tpu_torch.frontend.superpoint import load_superpoint
    from visualodometry_tpu_torch.models import weights
    from visualodometry_tpu_torch.models.train_superpoint import save_params
    from visualodometry_tpu_torch.models.train_superpoint_textured import pretrain_textured

    dev = resolve_device(None)
    init = None
    # curriculum: continue from the best prior stage (textured > blobs)
    for name in ("superpoint_textured.pkl", "superpoint_synthetic.pkl"):
        cand = weights.bundled(name)
        if cand.exists():
            init = load_superpoint(weights_path=cand)[0].to(dev)
            print(f"warm-starting from {cand}", flush=True)
            break

    model, log = pretrain_textured(steps=steps, batch=batch, hw=hw, init_model=init,
                                   corridor=corridor, device=dev)
    for i, loss, det, desc in log:
        print(f"step {i}: loss {loss:.3f} (det {det:.3f} desc {desc:.3f})", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_params(model, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
