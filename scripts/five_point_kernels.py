#!/usr/bin/env python3
"""Device kernels and time of the port's five-point solver, for one tree.

Runs `five_point_candidates` of the tree at `--tree` (this checkout by
default; a `git archive` of another commit unpacked elsewhere for a
before/after) on 256 minimal samples of a synthetic two-view scene, as
the main path's essential RANSAC calls it once per initialisation
attempt, on one NVIDIA GPU. Prints one JSON line: the device kernels of a
call and their busy time (torch.profiler), and how far the 4-dim null
basis the solver computes is from a float64 eigendecomposition of the
exact normal matrices of the same samples (projector difference, on
samples whose null space is defined).

    python3 scripts/five_point_kernels.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    sys.path.insert(1, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("five_point_kernels: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from visualodometry_tpu_torch.estimation import fivepoint

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, H = 240, 256
    X = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(5, 40, n)], 1)
    x0 = X[:, :2] / X[:, 2:]
    Xc = X + [0.05, 0.0, -1.2]
    x1 = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 0.3 / 500, (n, 2))
    idx = np.stack([rng.choice(n, 5, replace=False) for _ in range(H)])
    a = torch.as_tensor(x0[idx], dtype=torch.float32, device=dev)
    b = torch.as_tensor(x1[idx], dtype=torch.float32, device=dev)

    fivepoint.five_point_candidates(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fivepoint.five_point_candidates(a, b)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = cs.union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3

    # the basis the solver computes (its null_basis, as five_point_candidates
    # calls it), against a float64 eigendecomposition of the exact normal
    # matrices of the same samples
    seen = []
    null_basis = fivepoint.null_basis

    def spy(M, k, *a, **kw):
        V = null_basis(M, k, *a, **kw)
        seen.append(V)
        return V

    fivepoint.null_basis = spy
    try:
        fivepoint.five_point_candidates(a, b)
    finally:
        fivepoint.null_basis = null_basis
    V = seen[0].double().cpu().numpy()
    aa, bb = x0[idx], x1[idx]
    rows = np.stack([bb[..., 0] * aa[..., 0], bb[..., 0] * aa[..., 1], bb[..., 0],
                     bb[..., 1] * aa[..., 0], bb[..., 1] * aa[..., 1], bb[..., 1],
                     aa[..., 0], aa[..., 1], np.ones_like(aa[..., 0])], -1)
    rows = rows.astype(np.float32).astype(np.float64)
    M = np.einsum("hni,hnj->hij", rows, rows)
    w, U = np.linalg.eigh(M)
    ok = w[:, 4] > 1e-9 * np.trace(M, axis1=1, axis2=2)
    proj = np.abs(V @ V.transpose(0, 2, 1) - U[..., :4] @ U[..., :4].transpose(0, 2, 1))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps({
        "tree": os.path.abspath(args.tree), "hypotheses": H, "kernels": len(kernels),
        "busy_ms": busy, "basis_vs_float64_max": float(proj.max(axis=(1, 2))[ok].max()),
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
