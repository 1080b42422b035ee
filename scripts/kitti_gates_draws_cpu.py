#!/usr/bin/env python3
"""Why the port's KITTI-gates drift spreads wider over seeds than the JAX
package's: the RANSAC draws, the features, or the port's step. On the CPU.

The KITTI-gates configuration of chip_smoke.py (`get_config("kitti",
"sift")` with the renderer-matched edge threshold, global scale 2.4 and the
upsampled -1 octave) on the same 192 marathon frames (1226 x 370, one
blackout window at 120-123), stepped by the port's VO step frame by frame,
in every combination of:

- features: the port's extractor (`make_batched_extract_fn`, band-matmul
  pyramid) or the JAX package's (`jax.jit` of its `make_batched_extract_fn`,
  as scripts/kitti_gates_jax_cpu.py runs the JAX pipeline), chunks of 8;
- draws: the port's own (`torch.Generator` seeded with cfg.seed), or the JAX
  engine's (the key chain `jax.random.split(key, 3)` a frame from
  `jax.random.key(cfg.seed)`, given to the step's `sampler=`);
- seeds: cfg.seed in `--seeds` (0-3 by default).

`--steps JAX` also runs the JAX package's own step (`jax.jit(make_step_fn)`,
its draws from `VOState.rng_key`) frame by frame over the same features:
the JAX reference for exactly the inputs the port's step gets, where the
JAX pipeline of scripts/kitti_gates_jax_cpu.py extracts inside its fused
chunk program. `--features` and `--draws` pick a subset of the
combinations.

The matcher is the port's `match_descriptors` on CPU tensors, its float32
plain version, as the JAX run's `jnp` matcher is. The JAX package's own runs
of the path on the CPU (scripts/kitti_gates_jax_cpu.py --seed N) give the
largest segment ATE 7.658, 7.123, 7.066, 5.518 m at seeds 0-3. Prints one
JSON line per combination: resets and where, resets outside the explained
window [120, 183), keyframes, tracking at the end, the largest segment ATE.
Tracking outcomes only; the times are CPU times.

    JAX_PLATFORMS=cpu python scripts/kitti_gates_draws_cpu.py [--seeds 0 1 2 3] [--frames 192]
        [--steps port JAX] [--features port JAX] [--draws port JAX]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BLANK = (120, 123)
EXPLAINED = 60
CHUNK = 8


def report(run: dict, gt: np.ndarray, est, resets, inited, keyframes: int, t0: float) -> None:
    """Print one JSON line of a run's tracking outcome; `run` names it."""
    from visualodometry_tpu_torch.data.synthetic import segment_ate

    n = len(est)
    explained = np.zeros(n, bool)
    explained[BLANK[0] : min(BLANK[1] + EXPLAINED, n)] = True
    segs = segment_ate(est, gt[:n], resets)
    reset_frames = np.flatnonzero(resets)
    print(json.dumps({
        **run, "frames": n,
        "resets": int(resets.sum()), "reset_frames": reset_frames.tolist(),
        "resets_outside_window": int((~explained[reset_frames]).sum()),
        "keyframes": keyframes, "tracking_at_end": bool(inited[-1]),
        "segment_ate_max_m": max((a for _, _, a in segs), default=None),
        "segments": segs, "elapsed_s": round(time.perf_counter() - t0),
    }), flush=True)


def run_jax_step(jcfg, K, feats):
    """The JAX package's step over `feats` (port `Features` of CPU tensors),
    its draws from `VOState.rng_key` seeded with jcfg.seed: (positions,
    resets, initialized, keyframes)."""
    import jax
    import jax.numpy as jnp

    from visualodometry_tpu.core import init_state
    from visualodometry_tpu.core.step import make_step_fn
    from visualodometry_tpu.frontend.interface import Features

    step = jax.jit(make_step_fn(jcfg, np.asarray(K, np.float32)))
    state = init_state(jcfg, desc_dim=128)
    est, resets, inited, keyframes = [], [], [], 0
    for f in feats:
        state, out = step(state, Features(*(jnp.asarray(x.numpy()) for x in f)))
        est.append(np.asarray(out.T_wc)[:3, 3])
        resets.append(bool(out.did_reset))
        inited.append(bool(out.initialized))
        keyframes += bool(out.is_keyframe)
    return np.stack(est), np.array(resets), np.array(inited), keyframes


def run_port_step(cfg, K, feats, draws: str, seed: int):
    """The port's step over `feats` with its own draws or the JAX engine's
    key chain at `seed`: (positions, resets, initialized, keyframes)."""
    import jax
    import jax.numpy as jnp
    import torch

    from visualodometry_tpu.estimation.ransac import sample_valid_indices as jsample
    from visualodometry_tpu_torch.core import init_state, make_step_fn

    keys = {"key": jax.random.key(seed)}

    def sampler(valid, num_hypotheses, sample_size):
        k = keys["ess"] if sample_size in (5, 8) else keys["pnp"]
        idx = jsample(k, jnp.asarray(valid.numpy()), num_hypotheses, sample_size)
        return torch.as_tensor(np.array(idx)).long()

    step = make_step_fn(cfg, K, device="cpu", sampler=sampler if draws == "JAX" else None)
    state = init_state(cfg, desc_dim=128, device="cpu")
    outs = []
    with torch.no_grad():
        for f in feats:
            keys["key"], keys["ess"], keys["pnp"] = jax.random.split(keys["key"], 3)
            state, out = step(state, f)
            outs.append(out)
    est = torch.stack([o.T_wc for o in outs])[:, :3, 3].numpy()
    return (est, np.array([bool(o.did_reset) for o in outs]),
            np.array([bool(o.initialized) for o in outs]),
            int(sum(bool(o.is_keyframe) for o in outs)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=192)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--steps", nargs="+", default=["port"], choices=["port", "JAX"])
    ap.add_argument("--features", nargs="+", default=["port", "JAX"], choices=["port", "JAX"])
    ap.add_argument("--draws", nargs="+", default=["port", "JAX"], choices=["port", "JAX"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from visualodometry_tpu.config import get_config as jget_config
    from visualodometry_tpu.frontend.sift import make_batched_extract_fn as jextract_fn
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.data.synthetic import make_marathon_fixture
    from visualodometry_tpu_torch.frontend.interface import Features
    from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn

    torch.set_num_threads(args.threads)
    n = args.frames
    jcfg = jget_config("kitti", extractor="sift").replace(
        sift_edge_threshold=10.0, global_scale=2.4, matcher_backend="jnp",
        sift_first_octave=-1,
    )
    cfg0 = config_from_dict(dataclasses.asdict(jcfg))
    u8, gt, K, _ = make_marathon_fixture(
        num_frames=n, blanks=(BLANK,) if n > BLANK[1] else ())

    t0 = time.perf_counter()
    features = {}
    if "port" in args.features:
        extract = make_batched_extract_fn(cfg0, device="cpu")
        with torch.no_grad():
            features["port"] = [f for i in range(0, n, CHUNK)
                                for f in extract(torch.as_tensor(u8[i : i + CHUNK]))]
        print(f"port features: {time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)
    if "JAX" in args.features:
        vex = jax.jit(jextract_fn(jcfg))
        jf = []
        for i in range(0, n, CHUNK):
            f = jax.tree.map(np.asarray, vex(jnp.asarray(u8[i : i + CHUNK])))
            jf += [Features(*(torch.as_tensor(np.array(x[j])) for x in f))
                   for j in range(len(f.kps))]
        features["JAX"] = jf
        print(f"JAX features: {time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)

    for seed in args.seeds:
        for feat_name, feats in features.items():
            if "JAX" in args.steps:
                run = {"seed": seed, "step": "JAX", "features": feat_name, "draws": "JAX"}
                report(run, gt, *run_jax_step(jcfg.replace(seed=seed), K, feats), t0)
            if "port" not in args.steps:
                continue
            for draws in args.draws:
                run = {"seed": seed, "step": "port", "features": feat_name, "draws": draws}
                report(run, gt, *run_port_step(cfg0.replace(seed=seed), K, feats, draws, seed), t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
