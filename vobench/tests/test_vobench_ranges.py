"""vobench/harness/ranges.py on a hand-built event list: nested ranges
(a parent and its first child opening on one nanosecond), device gaps
split across ranges, and launches on a range's edges."""

from vobench.harness.ranges import attribute, owners

RANGES = [(100, 200, "step"), (100, 130, "step.match"), (140, 190, "step.solve"),
          (170, 170, "step.read_flags")]
LAUNCHES = [50, 100, 130, 140, 195, 200]
DEVICE = [(0, 60), (120, 125), (150, 160), (155, 158), (250, 300)]


def test_owners_take_the_innermost_range():
    assert owners(RANGES) == [(100, "step.match"), (130, "step"), (140, "step.solve"),
                              (190, "step"), (200, None)]


def test_launches_and_idle_time_go_to_the_range_the_host_was_in():
    got = attribute(RANGES, LAUNCHES, DEVICE)
    assert got["launches"] == 6
    # gaps (60, 120), (125, 150), (160, 250): 60 + 25 + 90 ns
    assert got["idle_ns"] == 175
    assert got["ranges"] == {
        None: {"launches": 2, "idle_ns": 40 + 50},  # before the step, and at its end
        "step.match": {"launches": 1, "idle_ns": 20 + 5},  # its first ns is its own
        "step": {"launches": 2, "idle_ns": 10 + 10},  # its self time only
        "step.solve": {"launches": 1, "idle_ns": 10 + 30},
    }
    assert sum(v["idle_ns"] for v in got["ranges"].values()) == got["idle_ns"]


def test_no_ranges_puts_everything_outside():
    got = attribute([], [5], [(0, 10), (20, 30)])
    assert got["ranges"] == {None: {"launches": 1, "idle_ns": 10}}
