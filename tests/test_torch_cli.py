"""The port's CLI, the slice's entry point, against the JAX CLI on the CPU.

A parking-layout tree (images/%06d.png, K.txt with the scene's K,
poses.txt) of the 640x192, 12-frame textured corridor of
tests/test_torch_pipeline.py, with that test's operating point (512
slots, 128 + 128 hypotheses, scene-matched gates) given as the --set list
that turns `get_config("parking", "sift")` into it.

- Chunked (`--chunk 4`): the port's CLI and the JAX CLI (`--set
  matcher_backend=jnp`: the Pallas matcher has no CPU mode) run the same
  frames and both report `ate_xz_sim3`, within 0.01 m of each other (the
  two draw other RANSAC samples; tests/test_torch_pipeline.py holds the
  same 0.01 m on this fixture).
- The port's per-frame mode with --ba --smooth, and its KLT mode: exit 0,
  every frame, a finite ATE.
- `--set` with an unknown field raises SystemExit in both CLIs.
- Without a CUDA device the default --platform raises: no silent CPU.
- `--viz` drives the Rerun sink (test_torch_viz.py's fake `rerun`).
"""

import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_viz import fake_rerun

import jax
from visualodometry_tpu import cli as jcli
from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu_torch import cli
from visualodometry_tpu_torch.config import config_from_dict, get_config
from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8

torch.set_num_threads(2)

SIZE = (640, 192)
FRAMES = 12
ATE_TOL_M = 0.01
_JAX_OPTIONS = ("jax_platforms", "jax_compilation_cache_dir",
                "jax_persistent_cache_min_entry_size_bytes",
                "jax_persistent_cache_min_compile_time_secs")


def _target():
    """tests/test_torch_pipeline.py's operating point, as a JAX config."""
    return JaxConfig(
        extractor_type="sift", max_keypoints=512, sift_n_features=512,
        sift_contrast_threshold=0.02, sift_num_octaves=3, min_median_flow=3.0,
        max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0,
        min_parallax_deg=0.35, lowe_ratio=0.8, essential_hypotheses=128,
        pnp_hypotheses=128, map_capacity=4096,
    )


def _sets():
    want = config_from_dict(dataclasses.asdict(_target()))
    base = get_config("parking", extractor="sift")
    pairs = []
    for f in dataclasses.fields(want):
        if getattr(want, f.name) != getattr(base, f.name):
            pairs += ["--set", f"{f.name}={getattr(want, f.name)}"]
    return pairs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    scene = make_scene(np.random.default_rng(7), num_frames=FRAMES, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=SIZE)
    park = root / "parking"
    (park / "images").mkdir(parents=True)
    for i, img in enumerate(render_fixture_u8(scene)):
        Image.fromarray(img).save(park / "images" / f"{i:06d}.png")
    (park / "K.txt").write_text(
        "\n".join(", ".join(repr(float(v)) for v in row) for row in scene.K) + "\n")
    poses = np.zeros((FRAMES, 12))
    poses[:, 3], poses[:, 11] = scene.gt_positions[:, 0], scene.gt_positions[:, 2]
    np.savetxt(park / "poses.txt", poses)
    return ["--dataset", "parking", "--path", str(root), *_sets()]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@contextlib.contextmanager
def _jax_options_kept():
    """The JAX CLI sets JAX's platform and compile-cache options for the
    process; put them back for the tests that follow."""
    saved = {k: getattr(jax.config, k) for k in _JAX_OPTIONS}
    try:
        yield
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def test_config_resolution(tree):
    args = cli.build_parser().parse_args(tree)
    assert cli.resolve_config(args) == config_from_dict(dataclasses.asdict(_target()))
    args = cli.build_parser().parse_args(tree + ["--max-keypoints", "256"])
    cfg = cli.resolve_config(args)
    assert cfg.max_keypoints == cfg.sift_n_features == 512  # --set comes last
    args = cli.build_parser().parse_args(["--dataset", "parking", "--max-keypoints", "256"])
    cfg = cli.resolve_config(args)
    assert cfg.max_keypoints == cfg.sift_n_features == 256


def test_chunked_cli_agrees_with_jax(tree):
    rc, res = _run(cli.main, tree + ["--chunk", "4", "--platform", "cpu"])
    with _jax_options_kept():
        rc_j, res_j = _run(jcli.main, tree + ["--chunk", "4", "--platform", "cpu",
                                              "--set", "matcher_backend=jnp"])
    assert rc == rc_j == 0
    assert res["frames"] == res_j["frames"] == FRAMES
    assert "ate_xz_sim3" in res and "ate_xz_sim3" in res_j, (res, res_j)
    assert res_j["ate_xz_sim3"] < 0.5  # the reference tracked
    assert abs(res["ate_xz_sim3"] - res_j["ate_xz_sim3"]) <= ATE_TOL_M, (res, res_j)


@pytest.mark.parametrize("mode", [["--ba", "--smooth"], ["--tracker", "klt"]],
                         ids=["per-frame-ba-smooth", "klt"])
def test_per_frame_and_klt_modes(tree, mode):
    rc, res = _run(cli.main, tree + mode + ["--platform", "cpu"])
    assert rc == 0 and res["frames"] == FRAMES
    assert np.isfinite(res["ate_xz_sim3"]) and res["ate_xz_sim3"] < 1.0, res


@pytest.mark.parametrize("pair", ["no_such_field=1", "min_depth"])
def test_unknown_set_field_raises_in_both(tree, pair):
    argv = tree + ["--platform", "cpu", "--set", pair]
    with pytest.raises(SystemExit, match="unknown config field"):
        cli.main(argv)
    with _jax_options_kept(), pytest.raises(SystemExit, match="unknown config field"):
        jcli.main(argv)


def test_default_platform_without_cuda_raises(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(tree + ["--chunk", "4"])


def test_viz_drives_the_rerun_sink(tree, monkeypatch):
    rr = fake_rerun()
    calls = rr.calls
    monkeypatch.setitem(sys.modules, "rerun", rr)
    rc, res = _run(cli.main, tree + ["--viz", "--max-frames", "3", "--platform", "cpu"])
    assert rc == 0 and res["frames"] == 3
    assert calls[0][0] == "init" and calls[0][2] == {"spawn": True}
    logged = [c[1][0] for c in calls if c[0] == "log"]
    assert logged.count("world/camera/image") == 3 and logged.count("metrics/speed") == 3
    images = [c[1][0] for c in calls if c[0] == "Image"]
    assert [im.shape for im in images] == [(SIZE[1], SIZE[0])] * 3
