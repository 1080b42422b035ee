"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
harness reads `configs[...]["file"]`, `vobench/traffic/<traffic>.json`,
`vobench/limits/<cell>.json` and, for each per-layer metric that lists
the cell, `vobench/metrics/<metric>.py`. Adding a cell, a configuration,
a mix or a metric adds files and entries; no code changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]  # vobench/
ROOT = BENCH_DIR.parent  # the checkout


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric is read in this cell (no `workloads` key: all)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    bench = bench or load_bench(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "vobench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "vobench" / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name) and m["moves"] in moved]
    return Cell(name, w, config, traffic, limits, e2e, layer)


def metric_reader(name: str, root: Path = ROOT):
    """`read(trace) -> float | None` from vobench/metrics/<name>.py."""
    path = root / "vobench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vobench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
