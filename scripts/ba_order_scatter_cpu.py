#!/usr/bin/env python3
"""How far the summation order alone moves a float32 BA solve, on the CPU.

bench.py:bench_ba_solve_ms's problem (20 keyframes x 5120 landmarks, seed 0,
landmarks perturbed by 0.1 m; chip_smoke.py's `_ba_solve_problem`), 8
Gauss-Newton iterations at damping 1e-4, solved by the port's `ba_solve` in
float64 (the reference) and in float32 with the landmarks in other orders
(`--orders` random permutations), each also split into 2 and 4 landmark
blocks whose reduced systems are summed as `ba_solve_distributed` sums
them across ranks. Every variant computes the same function; they differ
only in the order of float32 sums. Prints one JSON line per variant: the
largest pose and landmark difference from the float64 solve and from the
float32 solve in the problem's own order, and a summary line with the
largest of each. That spread is what a comparison of a distributed solve
with `ba_solve` can hold on this problem.

    python scripts/ba_order_scatter_cpu.py [--orders 24] [--iters 8] [--threads 2]

(~8 minutes; the thread count sets the CPU library's blocking, and with
it the orders of some sums.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--orders", type=int, default=24)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from visualodometry_tpu_torch.ba import BAProblem

    torch.set_num_threads(args.threads)
    damping = 1e-4
    prob = chip_smoke._ba_solve_problem(torch, "cpu")
    p64 = BAProblem(*(x.double() if x.is_floating_point() else x for x in prob))
    T64, X64 = chip_smoke.ba_split_reference(p64, 1, args.iters, damping)
    T32, X32 = chip_smoke.ba_split_reference(prob, 1, args.iters, damping)
    g = torch.Generator().manual_seed(0)
    worst = dict(pose_vs_f64=0.0, landmark_vs_f64=0.0, pose_vs_f32=0.0, landmark_vs_f32=0.0)
    for k in range(args.orders + 1):
        perm = torch.arange(prob.X.shape[0]) if k == 0 else torch.randperm(prob.X.shape[0],
                                                                            generator=g)
        inv = torch.argsort(perm)
        pp = BAProblem(prob.T_cw, prob.X[perm], prob.uv[perm], prob.mask[perm], prob.K)
        for blocks in (1, 2, 4):
            T, X = chip_smoke.ba_split_reference(pp, blocks, args.iters, damping)
            X = X[inv]
            row = dict(
                order=k, blocks=blocks,
                pose_vs_f64=float((T.double() - T64).abs().max()),
                landmark_vs_f64=float((X.double() - X64).abs().max()),
                pose_vs_f32=float((T - T32).abs().max()),
                landmark_vs_f32=float((X - X32).abs().max()),
            )
            for key in worst:
                worst[key] = max(worst[key], row[key])
            print(json.dumps(row), flush=True)
    print(json.dumps(dict(summary=True, iters=args.iters, orders=args.orders, **worst)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
