#!/usr/bin/env python3
"""The JAX package's tracking outcome on the KITTI-gates frames, on the CPU.

The reference for chip_smoke.py's KITTI-gates phases: the same
configuration (`get_config("kitti", "sift")` with the renderer-matched
edge threshold, global scale 2.4 and the upsampled -1 octave; the
matcher is the float32 `jnp` one, since the Pallas matcher has no CPU
mode outside interpret), the same frames (`make_marathon_fixture` at
1226 x 370, 192 frames, one blackout window at 120-123), chunks of 8,
through the JAX package's `make_chunked_pipeline_fn` with its default
band-matmul pyramid. Prints one JSON line: resets, resets outside the
explained window [120, 183), keyframes, tracking at the end, the largest
segment ATE. `--seed` sets cfg.seed, the RANSAC key (the config's 0 by
default). Tracking outcomes only: its times are CPU times and mean
nothing for the port.

    JAX_PLATFORMS=cpu python scripts/kitti_gates_jax_cpu.py [--frames 192] [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from visualodometry_tpu.config import get_config
    from visualodometry_tpu.core import init_state
    from visualodometry_tpu.core.runner import make_chunked_pipeline_fn
    from visualodometry_tpu.data.synthetic import make_marathon_fixture, segment_ate

    n, chunk, blank = args.frames, 8, (120, 123)
    cfg = get_config("kitti", extractor="sift").replace(
        sift_edge_threshold=10.0, global_scale=2.4, matcher_backend="jnp",
        sift_first_octave=-1, seed=args.seed,
    )
    u8, gt, K, _ = make_marathon_fixture(num_frames=n, blanks=(blank,))
    run = make_chunked_pipeline_fn(cfg, K)
    state = init_state(cfg, desc_dim=128)
    outs = []
    t0 = time.perf_counter()
    for i in range(0, n, chunk):
        state, out = run(state, jnp.asarray(u8[i : i + chunk]))
        outs.append(jax.tree.map(np.asarray, out))
        print(f"chunk {i // chunk}: {time.perf_counter() - t0:.0f} s", file=sys.stderr, flush=True)
    est = np.concatenate([o.T_wc[:, :3, 3] for o in outs])
    resets = np.concatenate([o.did_reset for o in outs])
    inited = np.concatenate([o.initialized for o in outs])
    explained = np.zeros(n, bool)
    explained[blank[0] : min(blank[1] + 60, n)] = True
    segs = segment_ate(est, gt, resets)
    print(json.dumps({
        "backend": jax.default_backend(),
        "seed": args.seed,
        "frames": n,
        "resets": int(resets.sum()),
        "reset_frames": np.flatnonzero(resets).tolist(),
        "resets_outside_window": int((~explained[np.flatnonzero(resets)]).sum()),
        "keyframes": int(sum(o.is_keyframe.sum() for o in outs)),
        "init_frames": (np.flatnonzero(np.diff(inited.astype(int)) > 0) + 1).tolist(),
        "tracking_at_end": bool(inited[-1]),
        "segment_ate_max_m": max((a for _, _, a in segs), default=None),
        "segments": segs,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
