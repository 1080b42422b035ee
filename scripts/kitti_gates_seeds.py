#!/usr/bin/env python3
"""The port's KITTI-gates drift over RANSAC seeds and pyramid routes.

Run from the root of a checkout:
    python3 scripts/kitti_gates_seeds.py [--seeds 0 1 2 3] [--routes auto pallas]
        [--device cuda|cpu] [--draws device|cpu]

chip_smoke.py's KITTI-gates path (`gates_config()`: `get_config("kitti",
"sift")` with the renderer-matched edge threshold, global scale 2.4 and
the upsampled -1 octave) on its 192 marathon frames (1226 x 370, a
blackout at 120-123), chunks of 8, once for every seed (cfg.seed, the
RANSAC stream) and route (`pyramid_impl`). `--draws cpu` takes the RANSAC
draws from a CPU `torch.Generator` seeded with cfg.seed, the stream the
port's own CPU runs draw from (scripts/kitti_gates_draws_cpu.py, "port"
draws), where the step's default generator lives on the device: a CUDA
generator gives other numbers for the same seed. So a card run with
`--draws cpu` differs from the CPU run only by the device's arithmetic. chip_smoke.py runs the
band-matmul route at GATES_SEEDS and holds their median against the JAX
package's own runs (scripts/kitti_gates_jax_cpu.py --seed N); this script
gives the wider seed set behind that limit. The step is deterministic for
a given device and seed (its dropping scatter keeps the last of repeated
entries), so one run a seed is enough.

Prints one JSON line a run: seed, route, resets and where, resets outside
the explained window, keyframes, tracking at the end, every segment's
sim3 ATE. `--device cpu` runs the plain kernel versions (~8 min a run on
two threads). Tracking outcomes only.
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


def cpu_sampler(torch, seed: int):
    """`sample_valid_indices` with its draws from a CPU generator seeded
    with `seed`, the indices on `valid`'s device (an upload, no read)."""
    gen = torch.Generator().manual_seed(seed)

    def sampler(valid, num_hypotheses, sample_size):
        order = torch.argsort((~valid).to(torch.int8), stable=True)
        count = torch.clamp(torch.sum(valid), min=1)
        draws = torch.randint(0, 2**31 - 1, (num_hypotheses, sample_size), generator=gen)
        return order[draws.to(valid.device) % count]

    return sampler


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--routes", nargs="+", default=["auto", "pallas"],
                    choices=["auto", "pallas"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--draws", default="device", choices=["device", "cpu"])
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn, make_step_fn
    from visualodometry_tpu_torch.core.runner import stack_outputs
    from visualodometry_tpu_torch.data.synthetic import make_marathon_fixture, segment_ate

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from visualodometry_tpu_torch.ops import _build

        _build.build_all()
    u8, gt, K, _ = make_marathon_fixture(num_frames=cs.GATES_FRAMES, blanks=(cs.GATES_BLANK,))
    lo, hi = cs.GATES_BLANK[0], min(cs.GATES_BLANK[1] + cs.GATES_EXPLAINED, len(u8))
    for route in args.routes:
        for seed in args.seeds:
            cfg = cs.gates_config().replace(seed=seed)
            run = make_chunked_pipeline_fn(cfg, K, device=dev, pyramid_impl=route)
            if args.draws == "cpu":
                step = make_step_fn(cfg, K, device=dev, sampler=cpu_sampler(torch, seed))

                def run(state, imgs, extract=run.extract, step=step):
                    outs = []
                    for f in extract(imgs):
                        state, out = step(state, f)
                        outs.append(out)
                    return state, stack_outputs(outs)

            state = init_state(cfg, desc_dim=128, device=dev)
            outs = []
            t0 = time.perf_counter()
            for i in range(0, len(u8), cs.CHUNK):
                state, out = run(state, torch.as_tensor(u8[i : i + cs.CHUNK]).to(dev))
                outs.append(out)
            T = torch.cat([o.T_wc for o in outs]).cpu().numpy()
            resets = torch.cat([o.did_reset for o in outs]).cpu().numpy()
            inited = torch.cat([o.initialized for o in outs]).cpu().numpy()
            kf = torch.cat([o.is_keyframe for o in outs]).cpu().numpy()
            at = np.flatnonzero(resets)
            segs = segment_ate(T[:, :3, 3], gt, resets)
            print(json.dumps({
                "device": args.device, "seed": seed, "route": route, "draws": args.draws,
                "resets": int(resets.sum()), "reset_frames": at.tolist(),
                "resets_outside_window": int(((at < lo) | (at >= hi)).sum()),
                "keyframes": int(kf.sum()), "tracking_at_end": bool(inited[-1]),
                "segment_ate_max_m": max((a for _, _, a in segs), default=None),
                "segments": segs, "seconds": round(time.perf_counter() - t0, 1),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
