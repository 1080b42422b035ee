"""BENCHMARK.json against the contract's characters and shapes, and the
harness finding every cell's files by name."""

import json
import re
import shutil

import pytest

from vobench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_bench()


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_names_and_units_use_allowed_characters():
    names = [m["name"] for m in _metrics()] + [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [c["source"] for c in BENCH["configs"]] + BENCH["command"]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_shape_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len({m["name"] for m in _metrics()}) == len(_metrics())
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert spec.reports(moved, cell), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["vo_config"]["image_size"] and c.traffic["mode"] in ("chunked", "online", "lanes")
    for key in ("kp_tol_px", "kp_unmatched", "k1_gap", "pose_gap", "id_mismatch"):
        assert key in c.limits
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for entry in BENCH["configs"]:
        assert (spec.ROOT / entry["file"]).is_file()
        assert entry["file"].startswith("vobench/")


def test_a_cell_added_as_data_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.ROOT / "vobench", root / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sift_kitti.short", "config": "sift_kitti",
                               "traffic": "short", "chips": 1, "why": "a mix added as data"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sift_kitti.offline" in m.get("workloads", ()):
            m["workloads"].append("sift_kitti.short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "vobench/traffic/offline.json").read_text())
    mix["drive_frames"] = 32
    (root / "vobench/traffic/short.json").write_text(json.dumps(mix))
    shutil.copy(root / "vobench/limits/sift_kitti.offline.json",
                root / "vobench/limits/sift_kitti.short.json")
    c = spec.load_cell("sift_kitti.short", root=root)
    assert c.traffic["drive_frames"] == 32
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "fps"}
    assert "mfu.superpoint" not in {m["name"] for m in c.per_layer}
    assert "step_ms.chunked" in {m["name"] for m in c.per_layer}
