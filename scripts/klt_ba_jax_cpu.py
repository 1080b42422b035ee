#!/usr/bin/env python3
"""The JAX package's tracking outcome on the KLT and BA paths, on the CPU.

The reference for chip_smoke.py's limits on those two paths: the same
frames (the 32-frame textured corridor at 1226 x 370, seed 7, speed 1.2,
chunks of 8) through the JAX package, once per stage:

- `klt`: `bench.py:bench_klt`'s loop at `bench.py:_build_cfg()` (4096
  slots, SIFT detections for replenishment batched per chunk, then the KLT
  step frame by frame). On the CPU, `klt_track(sampling="auto")` takes the
  gather path (ops/klt.py:300-303);
- `ba`: `bench.py:_build_cfg()` through `make_chunked_pipeline_fn(...,
  enable_ba=True)` (window of 5 keyframes, 512 landmarks, 8 iterations),
  with the float32 `jnp` matcher backend in place of the Pallas one, which
  has no CPU mode outside interpret.

Prints one JSON line per stage: resets, keyframes (BA) or promoted
landmarks (KLT), tracking on the last frame, sim3 ATE over frames 8
onward, and for BA the chunks whose window was full (the solve ran).
`--seeds` sets cfg.seed, the RANSAC key, one run (and one line) a
seed of a stage (0 by default, as the bench).
Tracking outcomes only: its times are CPU times and mean nothing for the
port.

    JAX_PLATFORMS=cpu python scripts/klt_ba_jax_cpu.py [--stage klt|ba] [--seeds 0 1 ...]
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


def run_klt(cfg, u8, K, chunk):
    import jax
    import jax.numpy as jnp

    from visualodometry_tpu.core.klt_step import init_klt_state, make_klt_step_fn
    from visualodometry_tpu.frontend.sift import make_batched_extract_fn

    H, W = u8.shape[1:]
    step = make_klt_step_fn(cfg, np.asarray(K, np.float32), (H, W))
    vex = jax.jit(make_batched_extract_fn(cfg))

    @jax.jit
    def run_chunk(state, imgs):
        feats = vex(imgs)
        return jax.lax.scan(lambda st, xs: step(st, *xs), state, (imgs, feats))

    state = init_klt_state(cfg, (H, W))
    outs = []
    t0 = time.perf_counter()
    for i in range(0, len(u8), chunk):
        state, out = run_chunk(state, jnp.asarray(u8[i : i + chunk]))
        outs.append(jax.tree.map(np.asarray, out))
        print(f"klt chunk {i // chunk}: {time.perf_counter() - t0:.0f} s",
              file=sys.stderr, flush=True)
    return outs, {}


def run_ba(cfg, u8, K, chunk):
    import jax
    import jax.numpy as jnp

    from visualodometry_tpu.ba.inloop import init_window
    from visualodometry_tpu.core import init_state
    from visualodometry_tpu.core.runner import make_chunked_pipeline_fn

    run = make_chunked_pipeline_fn(cfg, K, enable_ba=True)
    carry = (init_state(cfg, desc_dim=128), init_window(cfg))
    outs, counts = [], []
    t0 = time.perf_counter()
    for i in range(0, len(u8), chunk):
        carry, out = run(carry, jnp.asarray(u8[i : i + chunk]))
        outs.append(jax.tree.map(np.asarray, out))
        counts.append(int(carry[1].count))
        print(f"ba chunk {i // chunk}: {time.perf_counter() - t0:.0f} s",
              file=sys.stderr, flush=True)
    return outs, {"window_count_per_chunk": counts,
                  "ba_chunks": sum(c >= cfg.ba_window for c in counts)}


def print_stage(name, seed, outs, extra, gt, n):
    import jax

    from visualodometry_tpu.eval import ate_rmse

    est = np.concatenate([o.T_wc[:, :3, 3] for o in outs])
    inited = np.concatenate([o.initialized for o in outs])
    line = {
        "stage": name,
        "seed": seed,
        "backend": jax.default_backend(),
        "frames": n,
        "resets": int(sum(o.did_reset.sum() for o in outs)),
        "tracking": bool(inited[-1]),
        "init_frame": int(np.argmax(inited)) if inited.any() else None,
        "ate_sim3_m": float(ate_rmse(est[8:], gt[8:n], align="sim3")),
        **extra,
    }
    if name == "klt":
        tracked = np.concatenate([o.num_tracked for o in outs])
        line.update(
            promoted=int(sum(o.num_promoted.sum() for o in outs)),
            median_tracked=float(np.median(tracked[1:])),
            median_landmarks=float(np.median(
                np.concatenate([o.num_landmarks for o in outs])[inited])),
        )
    else:
        line["keyframes"] = int(sum(o.is_keyframe.sum() for o in outs))
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("klt", "ba"), action="append")
    ap.add_argument("--seeds", "--seed", dest="seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()

    from bench import _build_cfg
    from visualodometry_tpu.data.synthetic import make_scene, render_textured_image

    n, chunk = 32, 8
    scene = make_scene(np.random.default_rng(7), num_frames=n, speed=1.2,
                       turn_rate=0.002, image_size=(1226, 370))
    imgs = np.stack([render_textured_image(scene, f) for f in range(n)])
    u8 = (np.clip(imgs, 0, 1) * 255 + 0.5).astype(np.uint8)  # as bench.py's fixture
    stages = {
        "klt": (run_klt, _build_cfg()),
        "ba": (run_ba, _build_cfg().replace(matcher_backend="jnp")),
    }
    for name in args.stage or list(stages):
        fn, cfg = stages[name]
        for seed in args.seeds:
            print_stage(name, seed, *fn(cfg.replace(seed=seed), u8, scene.K, chunk),
                        scene.gt_positions, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
