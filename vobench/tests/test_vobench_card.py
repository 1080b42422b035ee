"""On the card only (marked `cuda`, skipped without one): one short run of
each cell through run.py, correct, with the result line's keys."""

import json
import subprocess
import sys

import pytest

from vobench.harness import spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load_bench()["workloads"]])
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "vobench/run.py", "--workload", cell, "--seed", "5",
                        "--seconds", "3", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
