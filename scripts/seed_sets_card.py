#!/usr/bin/env python3
"""The port's tracking outcomes over RANSAC seeds on the card: the evidence
behind chip_smoke.py's seed-set limits.

Runs chip_smoke.py's phases whose outcome the draws set, at every seed of
`--seeds` in place of the script's own seed sets, with each check that
fails logged (a line starting `CHECK FAILED`) instead of raised, so that
every seed's numbers are printed: the KLT path, the SuperPoint path, the
CLI (its KLT mode and the drill at the reference's KITTI gates) and the
long corridor. The main path runs first (the others reuse its frames).
Prints chip_smoke.py's log lines; the medians it prints are over
`--seeds`.

    python3 scripts/seed_sets_card.py [--seeds 0 1 ...] [--paths klt superpoint cli long_corridor]

on a machine with the GPU, from the root of a checkout (~15 minutes for seeds 0-7).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATHS = ("klt", "superpoint", "cli", "long_corridor")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=list(PATHS))
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from visualodometry_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("seed_sets_card: no CUDA device", file=sys.stderr)
        return 2
    failed = []

    def record(cond, what):
        if not cond:
            failed.append(what)
            cs.log(f"CHECK FAILED: {what}")

    cs.check = record
    seeds = tuple(args.seeds)
    cs.KLT_SEEDS = cs.SP_SEEDS = cs.CLI_KLT_SEEDS = cs.DRILL_SEEDS = cs.LONG_SEEDS = seeds
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"kernels built in {time.perf_counter() - t0:.1f} s; seeds {list(seeds)}")
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as render:
        drill = render.submit(cs.render_drill_fixture)
        long_corridor = render.submit(cs.render_long_corridor_fixture)
        _, scene, u8, _ = cs.timed("main_path", cs.phase_main_path, torch, dev, card)
        if "klt" in args.paths:
            cs.timed("klt", cs.phase_klt, torch, dev, card, scene, u8)
        if "superpoint" in args.paths:
            cs.timed("superpoint", cs.phase_learned, torch, dev, card, scene, u8, "superpoint")
        if "cli" in args.paths:
            with tempfile.TemporaryDirectory() as tmp:
                cs.timed("cli", cs.phase_cli, torch, dev, card, scene, u8, tmp, drill)
        if "long_corridor" in args.paths:
            cs.timed("long_corridor", cs.phase_long_corridor, torch, dev, card,
                     long_corridor.result(timeout=cs.DIST_TIMEOUT_S))
    cs.log(f"seed_sets_card.py: {len(failed)} checks failed in "
           f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
