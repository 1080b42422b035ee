"""What the harness and the reference load, and how run.py fails without
a card or without the program."""

import json
import shutil
import subprocess
import sys

import pytest

from vobench.harness import spec

ROOT = spec.ROOT


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    tops = _loaded(
        "import vobench.harness.cell, vobench.harness.systems, vobench.harness.judge\n"
        "import vobench.harness.trace, vobench.harness.counts\n"
        "from vobench.harness.cell import run_cell\n"
        "import vobench.harness.systems as s\n"
        "import visualodometry_tpu_torch.core.runner, visualodometry_tpu_torch.core.pipeline\n"
        "import visualodometry_tpu_torch.parallel.multiseq\n"
        "import vobench.reference.core.step, vobench.reference.frontend.superpoint\n"
        "for f in sorted(__import__('pathlib').Path('vobench/metrics').glob('*.py')):\n"
        "    __import__('vobench.harness.spec', fromlist=['x']).metric_reader(f.stem)\n")
    assert not tops & {"jax", "jaxlib", "flax", "visualodometry_tpu"}, tops


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded(
        "import vobench.reference.core.step, vobench.reference.frontend.sift\n"
        "import vobench.reference.frontend.superpoint, vobench.reference.precision\n"
        "from vobench.reference.frontend.superpoint import load_superpoint\n"
        "import json\n"
        "cfg = json.load(open('vobench/configs/superpoint_kitti.json'))\n"
        "load_superpoint(cfg['weights'])\n")
    assert not tops & {"jax", "jaxlib", "flax", "visualodometry_tpu", "visualodometry_tpu_torch"}


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "vobench/run.py", "--workload", "sift_kitti.offline", "--seed",
         "4294967311", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
    )


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run.py would run the cell")


def test_run_fails_without_a_card():
    _no_card()
    r = _run(ROOT)
    assert r.returncode != 0
    assert not r.stdout.strip()
    assert "no CUDA device" in r.stderr


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert not r.stdout.strip()
