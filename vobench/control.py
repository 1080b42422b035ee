#!/usr/bin/env python3
"""The readings the correctness limits are set from, on the card.

    python3 vobench/control.py --workload <cell> --seeds <n>... [--control-seeds <n>...]
        [--witness-seeds <n>...]

For each of `--seeds`, one run of the program; for each of
`--control-seeds`, one run of the control (the plain reference one
precision step down, in the program's place: TF32 for the configuration's
float32, float8 for its bf16 network); for each of `--witness-seeds`, one
run of the program judged by the reference on the CPU (with the card's
RANSAC draws): a sound witness that differs from the card only in float
order, the headroom a correct reordering needs. Each run lasts as long as it takes
to hand in every frame the check reads, at the cell's own sizes, and
prints one line: `{"side", "seed", "correct", "checks"}`. The benchmark's
own runs (run.py) never run the control.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("vobench control: no CUDA device", file=sys.stderr)
        return 3
    from vobench.harness.cell import run_cell

    sides = (("program", args.seeds), ("control", args.control_seeds),
             ("witness", args.witness_seeds))
    for side, seeds in sides:
        for seed in seeds:
            r = run_cell(args.workload, seed, 0.0, False, device="cuda", root=ROOT,
                         program=side != "control", until_checked=True,
                         ref_device="cpu" if side == "witness" else None)
            print(json.dumps({"side": side, "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"], "failed": r["failed"],
                              "checks": {k: v["value"] for k, v in r["checks"].items()}}),
                  flush=True)
            for row in r["_detail"]:
                print(json.dumps({"side": side, "seed": seed, "frame": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
