#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on one CUDA device.

    python3 vobench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number the correctness check
compared, with its limit (also the last lines of standard error).
Earlier lines: the card, launches per frame, each drive's outcome.

Exits non-zero with no result when CUDA is missing or the cell asks for
more devices than there are, when JAX or the JAX package
(`visualodometry_tpu`) is loaded, or when the checkout lacks the program.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".vobench_cache"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # one process with one intra-op thread: the window is host-bound (kernel
    # launches), and idle pool threads only take cores from it
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # every build and kernel cache at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    from vobench.harness import spec

    bench = spec.load_bench(ROOT)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"vobench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("vobench: no CUDA device; the benchmark does not run on the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cells[args.workload]["chips"]:
        print(f"vobench: the cell needs {cells[args.workload]['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        import visualodometry_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"vobench: the program is not in this checkout: {e}", file=sys.stderr)
        return 4

    from vobench.harness.cell import forbidden_modules, run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", root=ROOT, t_start=T_START)
    result.pop("_forbidden")
    result.pop("_detail")
    found = forbidden_modules()
    if found:
        print(f"vobench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
