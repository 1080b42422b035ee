#!/usr/bin/env python3
"""Device times of K1, K2 and K3 in two trees of the port, on one card, in turns.

    python3 scripts/ab_torch_kernels.py --parent DIR [--rounds 2]

DIR holds another checkout of the repo (for instance `git archive <commit>`
unpacked into a git-ignored directory). The script starts one worker process
per tree, in the order parent, this tree, this tree, parent, `--rounds`
times over. A worker imports the port from its own tree, builds that tree's
kernels, and times `match_top2` at 4096 x 4096 x 128, `extract_patches`
at the main path's three octave shapes (a frame's three launches, each and
summed), and `blur_stack` at the KITTI-gates path's five launch shapes
(B = 8; each, and summed divided by 8 for a frame's share). On the same
seeded inputs it also takes a SHA-256 digest of K3's output bytes at those
shapes and at chip_smoke.py's extra K3 shapes; the summary says whether the
two trees' K3 outputs are bit-equal at every shape.

Times are device times, taken with chip_smoke.py's `time_ms` of this tree: a
batch of calls is queued behind a spin kernel that keeps the card busy while
the host enqueues, and two CUDA events bracket the batch. A single call
between two events reads the host's launch time for kernels this short. Each
worker prints one JSON line; the last line is the per-tree median.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This tree's chip_smoke.py (its shapes and its device timer), whatever
    tree the worker imports the port from."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str) -> int:
    cs = _chip_smoke()
    sys.path.insert(0, root)
    import torch

    from visualodometry_tpu_torch.ops import match_top2 as m
    from visualodometry_tpu_torch.ops import patches as p

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    d0 = torch.randn(4096, 128, generator=g, device=dev)
    d1 = torch.randn(4096, 128, generator=g, device=dev)
    d0 /= d0.norm(dim=1, keepdim=True)
    d1 /= d1.norm(dim=1, keepdim=True)
    valid1 = torch.rand(4096, generator=g, device=dev) >= 0.1
    k1 = cs.time_ms(torch, lambda: m.match_top2(d0, d1, valid1), batches=5)
    k2 = []
    PATCH_Y, PATCH_X = cs.PATCH_Y, cs.PATCH_X
    for L, H, W, K in cs.PATCH_SHAPES:
        field = torch.randint(-(2**31), 2**31 - 1, (L, H, W), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
        lvl = torch.randint(0, L, (K,), generator=g, device=dev).to(torch.int32)
        y0 = torch.randint(0, H - PATCH_Y + 1, (K,), generator=g, device=dev).to(torch.int32)
        x0 = torch.randint(0, W - PATCH_X + 1, (K,), generator=g, device=dev).to(torch.int32)
        out = p.extract_patches(field, lvl, y0, x0, PATCH_Y, PATCH_X)
        ref = p._extract_patches_torch(field, lvl, y0, x0, PATCH_Y, PATCH_X)
        if not torch.equal(out, ref):
            raise AssertionError(f"K2 disagrees with its plain version at {(L, H, W)}")
        k2.append(cs.time_ms(torch, lambda: p.extract_patches(
            field, lvl, y0, x0, PATCH_Y, PATCH_X, check_bounds=False), batches=5))
    k3, digests = _blur_stack(torch, cs, dev)
    print(json.dumps({"tree": root, "match_top2_ms": k1, "extract_patches_ms": sum(k2),
                      "extract_patches_ms_by_launch": k2, "blur_stack_ms": sum(k3) / cs.CHUNK,
                      "blur_stack_ms_by_launch": k3, "blur_stack_sha256": digests}), flush=True)
    return 0


def _blur_stack(torch, cs, dev):
    """K3's device time at each KITTI-gates launch shape, and the digests of
    its outputs at those and the extra shapes, on inputs seeded per shape."""
    import hashlib

    from visualodometry_tpu_torch.ops import pyramid as py

    times, digests = [], {}
    for C, H, W in cs.GATES_BLUR_SHAPES + cs.EXTRA_BLUR_SHAPES:
        g = torch.Generator(device=dev).manual_seed(C * 100003 + H * 1009 + W)
        img = torch.rand(cs.CHUNK, H, W, generator=g, device=dev)
        taps = cs._blur_taps(C, H)
        out = py.blur_stack(img, taps)
        digests[f"{C}x{H}x{W}"] = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        if (C, H, W) in cs.GATES_BLUR_SHAPES:
            times.append(cs.time_ms(torch, lambda: py.blur_stack(img, taps), batches=5))
    return times, digests


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    if not args.parent:
        ap.error("--parent is required")
    here = HERE
    parent = os.path.abspath(args.parent)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    for _ in range(args.rounds):
        for root in (parent, here, here, parent):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", root],
                capture_output=True, text=True, check=True,
            ).stdout.strip().splitlines()[-1]
            print(out, flush=True)
            rows.append(json.loads(out))
    import numpy as np

    summary = {"card": smi}
    for name, root in (("parent", parent), ("this", here)):
        mine = [r for r in rows if r["tree"] == root]
        summary[name] = {k: np.median([r[k] for r in mine], axis=0).tolist()
                         for k in ("match_top2_ms", "extract_patches_ms",
                                   "extract_patches_ms_by_launch", "blur_stack_ms",
                                   "blur_stack_ms_by_launch")}
    # every run of both trees must give the same K3 bytes at every shape
    digests = [r["blur_stack_sha256"] for r in rows]
    summary["blur_stack_bit_equal"] = {
        shape: len({d[shape] for d in digests}) == 1 for shape in digests[0]
    }
    summary["blur_stack_bit_equal_everywhere"] = all(summary["blur_stack_bit_equal"].values())
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
