"""The correctness check at a size a test run holds, on the CPU: a sound
run reads correct; the control (the reference one precision step down in
the program's place) and each fault a cell can have read not correct.

The harness's look for a card is skipped (`run_cell` on the CPU); the rest
of a run is driven as on the card, at small frames, slot counts and drives.
TF32 does not exist on the CPU, so there the control's lowering reaches
the pyramid's band matmuls (operands rounded to TF32) and the SuperPoint
network (float8), which is enough to fail it.
"""

import pytest

from vobench.harness import spec
from vobench.harness.cell import run_cell

SMALL = {
    "config": {"vo_config": {"image_size": [192, 112], "max_keypoints": 256,
                             "sift_n_features": 256, "map_capacity": 2048,
                             "essential_hypotheses": 64, "pnp_hypotheses": 64}},
    "traffic": {"drive_frames": 12, "warmup_frames": 4, "check": {"drives": 1, "frames": 6},
                "trace": {"stretch_start": 4, "stretch_frames": 4}},
}
CELLS = ("sift_kitti.offline", "superpoint_kitti.offline", "sift_kitti.online",
         "sift_kitti.lanes4")
# the lanes mix has files (traffic/lanes4.json, limits/sift_kitti.lanes4.json)
# but no cell in BENCHMARK.json yet: it is added here as data
BENCH = spec.load_bench()
BENCH["workloads"].append({"name": "sift_kitti.lanes4", "config": "sift_kitti",
                           "traffic": "lanes4", "chips": 1, "why": "lanes"})


def _run(cell, seed=2**31 + 11, **kw):
    over = {"config": SMALL["config"],
            "traffic": dict(SMALL["traffic"], chunk=1 if cell.endswith("online") else 4)}
    return run_cell(cell, seed, 0.1, False, device="cpu", overrides=over, workers=2,
                    until_checked=True, bench=BENCH, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 12 and not r["_forbidden"]
    assert list(r)[-3:] == ["checks", "_forbidden", "_detail"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = _run(cell, program=False)
    assert not r["correct"], r["checks"]


FAULTS = [(c, f) for c in CELLS for f in ("frozen_state", "altered_answer")]
FAULTS += [(c, "half_batch") for c in CELLS if not c.endswith("online")]
# the program computes rightly but routes around the harness's hooks: the
# check must fail closed, not read the frames it never saw as agreeing
FAULTS += [(c, "unobserved_step") for c in CELLS if not c.endswith("lanes4")]
FAULTS += [(c, "unobserved_k1") for c in CELLS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert not r["correct"], r["checks"]
    if fault.startswith("unobserved"):
        assert r["checks"]["frames_unchecked"]["value"] > 0, r["checks"]
