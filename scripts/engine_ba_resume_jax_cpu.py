#!/usr/bin/env python3
"""The JAX package's `VOEngine(enable_ba=True)` resumed from a checkpoint,
on the CPU: the reference for chip_smoke.py's ENGINE_BA_RESUME_FRACTION.

chip_smoke.py's engine-with-BA phase runs the port's engine on the first
16 frames of the 32-frame textured corridor (1226 x 370, seed 7, speed
1.2) at the bench configuration, once without a break and once saved
after frame 8 and resumed in a fresh engine; the resumed track's largest
position difference from the uninterrupted one, as a share of the
uninterrupted path's length, is the gap it holds. This script measures
the same gap for the JAX package: the engine has no `save_state`, so the
state goes through `core/checkpoint.save_state(engine.state, path)` and
`load_state(path, template)` into a fresh engine's `state` (the RANSAC
key travels in `VOState.rng_key`). As in the port, the host's keyframe
window is not in the checkpoint, so the resumed engine solves its first
window later. The matcher is the float32 `jnp` one (the Pallas matcher
has no CPU mode outside interpret).

Prints one JSON line a seed (cfg.seed, the RANSAC key): resets, BA
edges, the path length, the largest difference and its share. Tracking
outcomes only; the times are CPU times.

    JAX_PLATFORMS=cpu python scripts/engine_ba_resume_jax_cpu.py [--seeds 0 1 2 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FRAMES, RESUME_AT = 16, 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()

    from bench import _build_cfg
    from visualodometry_tpu.core.checkpoint import load_state, save_state
    from visualodometry_tpu.core.pipeline import VOEngine
    from visualodometry_tpu.data.synthetic import make_scene, render_textured_image

    scene = make_scene(np.random.default_rng(7), num_frames=32, speed=1.2,
                       turn_rate=0.002, image_size=(1226, 370))
    imgs = np.stack([render_textured_image(scene, f) for f in range(FRAMES)])
    u8 = (np.clip(imgs, 0, 1) * 255 + 0.5).astype(np.uint8)  # as bench.py's fixture
    for seed in args.seeds:
        t0 = time.perf_counter()
        cfg = _build_cfg().replace(matcher_backend="jnp", seed=seed)
        whole = VOEngine(scene.K, cfg, enable_ba=True)
        outs = [whole.process_frame(img) for img in u8]
        first = VOEngine(scene.K, cfg, enable_ba=True)
        for img in u8[:RESUME_AT]:
            first.process_frame(img)
        resumed = VOEngine(scene.K, cfg, enable_ba=True)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state.npz")
            save_state(first.state, path)
            resumed.state = load_state(path, resumed.state)
        r_outs = [resumed.process_frame(img) for img in u8[RESUME_AT:]]
        pos = whole.positions()
        length = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
        diff = float(np.abs(pos[RESUME_AT:] - resumed.positions()).max())
        print(json.dumps({
            "seed": seed, "frames": FRAMES, "resume_at": RESUME_AT,
            "resets": sum(bool(o.did_reset) for o in outs),
            "resumed_resets": sum(bool(o.did_reset) for o in r_outs),
            "keyframes": sum(bool(o.is_keyframe) for o in outs),
            "ba_edges": len(whole._ba_edges),
            "path_length": length, "max_position_difference": diff,
            "fraction": diff / length, "seconds": round(time.perf_counter() - t0, 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
