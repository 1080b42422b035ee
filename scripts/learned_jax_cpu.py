#!/usr/bin/env python3
"""The JAX package's tracking outcome on the learned paths, on the CPU.

The reference for chip_smoke.py's keyframe limits on the two learned
paths: the same frames (the 32-frame textured corridor at 1226 x 370,
seed 7, speed 1.2, chunks of 8) through the JAX package's
`make_chunked_pipeline_fn`, once per stage of bench.py's learned
measurements:

- `superpoint`: `get_config("kitti", "superpoint")` with
  `bench.py:_build_superpoint_cfg`'s overrides (2048 slots, P3P, the dense
  SuperPoint weights, bf16 backbone, Lowe 0.92);
- `attention`: `bench.py:_build_cfg()` with `matcher_type="attention"`
  (4096 SIFT slots, the v2 matcher weights, pruning to 1024, exit at 0.95,
  bf16), with the float32 `jnp` matcher backend in place of the Pallas one,
  which has no CPU mode outside interpret (the attention path does not
  call it).

Prints one JSON line per stage and seed: resets, keyframes, sim3 ATE over
frames 8 onward. `--seeds` sets the RANSAC key (`init_state`'s seed, which
is all that cfg.seed sets; 0 by default), one run a seed on one compile.
Tracking outcomes only: its times are CPU times and mean nothing for the
port.

    JAX_PLATFORMS=cpu python scripts/learned_jax_cpu.py [--stage superpoint|attention] [--seeds 0 1 ...]
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
    ap.add_argument("--stage", choices=("superpoint", "attention"), action="append")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bench import _build_cfg, _build_superpoint_cfg
    from visualodometry_tpu.core import init_state
    from visualodometry_tpu.core.runner import make_chunked_pipeline_fn
    from visualodometry_tpu.data.synthetic import make_scene, render_textured_image
    from visualodometry_tpu.eval import ate_rmse

    n, chunk = 32, 8
    scene = make_scene(np.random.default_rng(7), num_frames=n, speed=1.2,
                       turn_rate=0.002, image_size=(1226, 370))
    imgs = np.stack([render_textured_image(scene, f) for f in range(n)])
    u8 = (np.clip(imgs, 0, 1) * 255 + 0.5).astype(np.uint8)  # as bench.py's fixture
    stages = {
        "superpoint": (_build_superpoint_cfg(), 256),
        "attention": (_build_cfg().replace(matcher_type="attention",
                                           matcher_backend="jnp"), 128),
    }
    for name in args.stage or list(stages):
        cfg, desc_dim = stages[name]
        run = make_chunked_pipeline_fn(cfg, scene.K)
        for seed in args.seeds:
            state = init_state(cfg, desc_dim=desc_dim, seed=seed)
            outs = []
            t0 = time.perf_counter()
            for i in range(0, n, chunk):
                state, out = run(state, jnp.asarray(u8[i : i + chunk]))
                outs.append(jax.tree.map(np.asarray, out))
                print(f"{name} seed {seed} chunk {i // chunk}: {time.perf_counter() - t0:.0f} s",
                      file=sys.stderr, flush=True)
            est = np.concatenate([o.T_wc[:, :3, 3] for o in outs])
            print(json.dumps({
                "stage": name,
                "seed": seed,
                "backend": jax.default_backend(),
                "frames": n,
                "resets": int(sum(o.did_reset.sum() for o in outs)),
                "keyframes": int(sum(o.is_keyframe.sum() for o in outs)),
                "ate_sim3_m": float(ate_rmse(est[8:], scene.gt_positions[8:n], align="sim3")),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
