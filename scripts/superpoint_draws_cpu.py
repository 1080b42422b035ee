#!/usr/bin/env python3
"""Why the port's SuperPoint path tracks with a larger ATE than the JAX
package: the RANSAC draws, or the features. On the CPU.

The SuperPoint path of chip_smoke.py (`get_config("kitti", "superpoint")`
with bench.py:_build_superpoint_cfg's overrides, the dense weights) on the
32-frame textured corridor (1226 x 370, seed 7, speed 1.2), stepped by the
port's VO step frame by frame, in every combination of:

- features: the port's extractor with the network in bf16 (the JAX
  contract) or in float32, or the JAX package's extractor (bf16);
- draws: the port's own (`torch.Generator` seeded with cfg.seed), or the
  JAX engine's (the key chain `jax.random.split(key, 3)` a frame from
  `jax.random.key(cfg.seed)`, given to the step's `sampler=`).

The JAX package's own run of the path on the CPU gives sim3 ATE 0.0316 m
(scripts/learned_jax_cpu.py). Prints one JSON line per combination: resets,
keyframes, sim3 ATE over frames 8 onward. Tracking outcomes only.

    JAX_PLATFORMS=cpu python scripts/superpoint_draws_cpu.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from bench import _build_superpoint_cfg
    from visualodometry_tpu.estimation.ransac import sample_valid_indices as jsample
    from visualodometry_tpu.frontend.superpoint import make_superpoint_extract_fn
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.core import init_state, make_step_fn
    from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
    from visualodometry_tpu_torch.eval import ate_rmse
    from visualodometry_tpu_torch.frontend.interface import Features
    from visualodometry_tpu_torch.frontend.superpoint import make_batched_superpoint_extract_fn

    torch.set_num_threads(4)
    jcfg = _build_superpoint_cfg()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    n, chunk = 32, 8
    scene = make_scene(np.random.default_rng(7), num_frames=n, speed=1.2,
                       turn_rate=0.002, image_size=(1226, 370))
    u8 = render_fixture_u8(scene)

    features = {}
    for name, dtype in (("port bf16", torch.bfloat16), ("port float32", torch.float32)):
        extract = make_batched_superpoint_extract_fn(cfg, device="cpu", compute_dtype=dtype)
        features[name] = [f for i in range(0, n, chunk)
                          for f in extract(torch.as_tensor(u8[i : i + chunk]))]
    vex = jax.jit(jax.vmap(make_superpoint_extract_fn(jcfg)))
    jf = []
    for i in range(0, n, chunk):
        f = jax.tree.map(np.asarray, vex(jnp.asarray(u8[i : i + chunk])))
        jf += [Features(*(torch.as_tensor(np.array(x[j])) for x in f)) for j in range(len(f.kps))]
    features["JAX bf16"] = jf

    for feat_name, feats in features.items():
        for draws in ("port", "JAX"):
            keys = {"key": jax.random.key(cfg.seed)}

            def sampler(valid, num_hypotheses, sample_size):
                k = keys["ess"] if sample_size == 5 else keys["pnp"]
                idx = jsample(k, jnp.asarray(valid.numpy()), num_hypotheses, sample_size)
                return torch.as_tensor(np.array(idx)).long()

            step = make_step_fn(cfg, scene.K, device="cpu",
                                sampler=sampler if draws == "JAX" else None)
            state = init_state(cfg, desc_dim=256, device="cpu")
            outs = []
            for f in feats:
                keys["key"], keys["ess"], keys["pnp"] = jax.random.split(keys["key"], 3)
                state, out = step(state, f)
                outs.append(out)
            est = torch.stack([o.T_wc for o in outs])[:, :3, 3].numpy()
            print(json.dumps({
                "features": feat_name, "draws": draws,
                "resets": int(sum(bool(o.did_reset) for o in outs)),
                "keyframes": int(sum(bool(o.is_keyframe) for o in outs)),
                "ate_sim3_m": float(ate_rmse(est[8:], scene.gt_positions[8:n], align="sim3")),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
