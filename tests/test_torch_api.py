"""The port's public names against the JAX package's, on the CPU.

Every name that an `__init__.py` of `visualodometry_tpu` exports (read by
an AST parse of the JAX package, not from a list typed here) must exist
in the port's same-named package. The functions that only the public API
reaches (`compute_orientations`, `gaussian_kernel_1d`, `transform_points`,
`best_hypothesis`, `SuperPointOutput`) are held against their JAX
counterparts on numpy-seeded inputs.
"""

import ast
import importlib
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.data.synthetic import make_scene, render_textured_image
from visualodometry_tpu.estimation import ransac as jransac
from visualodometry_tpu.frontend import sift as jsift
from visualodometry_tpu.geometry import se3 as jse3
from visualodometry_tpu.models import superpoint as jsp
from visualodometry_tpu.ops import pyramid as jpyr
from visualodometry_tpu_torch.estimation import ransac as transac
from visualodometry_tpu_torch.frontend import sift as tsift
from visualodometry_tpu_torch.geometry import se3 as tse3
from visualodometry_tpu_torch.models import superpoint as tsp
from visualodometry_tpu_torch.ops import pyramid as tpyr

torch.set_num_threads(2)

JAX_ROOT = pathlib.Path(__file__).resolve().parents[1] / "visualodometry_tpu"


def _exports(init: pathlib.Path) -> set[str]:
    """Public names bound at the top level of an `__init__.py`."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _jax_packages():
    for init in sorted(JAX_ROOT.rglob("__init__.py")):
        rel = init.parent.relative_to(JAX_ROOT.parent)
        yield ".".join(rel.parts), init


def test_the_parse_finds_the_jax_exports():
    """The parse sees re-exports, names bound by `import` and definitions:
    40 names in 11 packages when this was written."""
    pkgs = dict(_jax_packages())
    assert {"visualodometry_tpu", "visualodometry_tpu.core", "visualodometry_tpu.frontend",
            "visualodometry_tpu.estimation", "visualodometry_tpu.geometry"} <= set(pkgs)
    assert {"Features", "match_descriptors"} <= _exports(pkgs["visualodometry_tpu.frontend"])
    assert {"Keyframe", "MapState", "landmark_lookup", "init_state"} <= _exports(
        pkgs["visualodometry_tpu.core"])
    assert sum(len(_exports(p)) for p in pkgs.values()) >= 40


@pytest.mark.parametrize("package", [name for name, _ in _jax_packages()])
def test_every_jax_export_exists_in_the_port(package):
    init = dict(_jax_packages())[package]
    port = importlib.import_module(package.replace("visualodometry_tpu", "visualodometry_tpu_torch", 1))
    missing = sorted(n for n in _exports(init) if not hasattr(port, n))
    assert missing == [], f"{port.__name__} lacks {missing}"


@pytest.mark.parametrize("package, name, module", [
    ("frontend", "match_descriptors", "frontend.matcher"),
    ("geometry", "so3_log", "geometry.so3"),
    ("estimation", "estimate_essential_ransac", "estimation.essential"),
    ("estimation", "recover_pose", "estimation.essential"),
    ("estimation", "solve_pnp_ransac", "estimation.pnp"),
    ("core", "Keyframe", "core.state"),
    ("core", "MapState", "core.state"),
    ("core", "landmark_lookup", "core.state"),
])
def test_reexports_are_the_module_objects(package, name, module):
    pkg = importlib.import_module(f"visualodometry_tpu_torch.{package}")
    mod = importlib.import_module(f"visualodometry_tpu_torch.{module}")
    assert getattr(pkg, name) is getattr(mod, name)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 1.2489996, 1.6, 2.015874, 3.2])
def test_gaussian_kernel_1d_matches_jax(sigma):
    """The same numpy taps on both sides: bit-equal."""
    got = tpyr.gaussian_kernel_1d(sigma)
    want = np.asarray(jpyr.gaussian_kernel_1d(sigma))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert len(want) == 2 * max(1, math.ceil(3.0 * sigma)) + 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_transform_points_matches_jax():
    """(2, 3, 4, 4) poses on (2, 3, 50, 3) points, and one pose broadcast
    over a batch: float32, three products a coordinate, so 2e-6 relative
    to the points' scale of ~10."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.5, (2, 3, 6)).astype(np.float32)
    T = np.array(jse3.se3_exp(jnp.asarray(xi)))
    pts = rng.uniform(-10, 10, (2, 3, 50, 3)).astype(np.float32)
    want = np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    got = tse3.transform_points(torch.as_tensor(T), torch.as_tensor(pts)).numpy()
    assert got.shape == want.shape == (2, 3, 50, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    one = tse3.transform_points(torch.as_tensor(T[0, 0]), torch.as_tensor(pts[1]))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jse3.transform_points(jnp.asarray(T[0, 0]), jnp.asarray(pts[1]))),
        rtol=0, atol=2e-5)


@pytest.mark.parametrize("counts", [
    [3, 7, 7, 1, 7],  # ties: the first maximum
    [0, 0, 0, 0],
    [5],
    [1, 2, 3, 4, 9, 9],
    list(np.random.default_rng(1).integers(0, 4, 256)),
])
def test_best_hypothesis_matches_jax_argmax(counts):
    a = np.asarray(counts, np.int32)
    got = transac.best_hypothesis(torch.as_tensor(a))
    assert got.ndim == 0
    assert int(got) == int(jransac.best_hypothesis(jnp.asarray(a)))


def test_superpoint_output_fields():
    assert tsp.SuperPointOutput._fields == jsp.SuperPointOutput._fields
    out = tsp.SuperPointOutput(torch.zeros(16, 24), torch.zeros(2, 3, 256))
    assert out.heatmap.shape == (16, 24) and out.coarse_desc.shape[-1] == 256


@pytest.fixture(scope="module")
def octave0():
    """JAX's Gaussian octave 0 and its keypoints of a 320 x 192 corridor frame,
    and the same keypoints as the port's `OctaveKeypoints`."""
    scene = make_scene(np.random.default_rng(7), num_frames=1, speed=1.2, turn_rate=0.002,
                       num_landmarks=2, image_size=(320, 192))
    img = np.clip(render_textured_image(scene, 0), 0, 1).astype(np.float32)
    cfg = JaxConfig(extractor_type="sift", max_keypoints=512, sift_n_features=512,
                    sift_contrast_threshold=0.02, sift_num_octaves=3)
    gauss, dogs = jpyr.build_pyramid(jnp.asarray(img), 3, 3, sigma0=1.6)
    kj = jsift.detect_octave(dogs[0], cfg, 256)
    kt = tsift.OctaveKeypoints(
        xy=torch.as_tensor(np.asarray(kj.xy)),
        scale_idx=torch.as_tensor(np.asarray(kj.scale_idx)).long(),
        sigma_rel=torch.as_tensor(np.asarray(kj.sigma_rel)),
        response=torch.as_tensor(np.asarray(kj.response)),
        valid=torch.as_tensor(np.asarray(kj.valid)),
    )
    return gauss[0], kj, kt


@pytest.mark.parametrize("mode", ["gather", "patch"])
def test_compute_orientations_matches_jax(octave0, mode):
    """The same octave and keypoints through both packages' gather paths,
    and the port's patch sampler (K2's plain version on the CPU) against
    JAX's gather path, on all 256 slots (valid or not). The histograms are
    float32 sums in other orders, so an angle may move by float order; a
    tap that crosses a bin edge, or a top bin that changes, moves it by
    much more. Measured: every angle within 4.8e-7 rad on both paths."""
    g_j, kj, kt = octave0
    want = np.asarray(jsift.compute_orientations(g_j, kj))
    gauss = torch.as_tensor(np.asarray(g_j))
    if mode == "gather":
        got = tsift.compute_orientations(gauss, kt)
    else:
        P = tsift._patch_size(tsift.VOConfig())
        _, H, W = gauss.shape
        h_pad, w_pad = -(-H // 8) * 8, tsift._padded_width(W, P)
        field = tsift._pack_gradients_planar(gauss, h_pad, w_pad)
        y0, x0 = tsift._patch_origins(kt, H, W, h_pad, P)
        lvl = torch.clamp(kt.scale_idx, 0, field.shape[0] - 1).to(torch.int32)
        patches = tsift._unpack_patches(
            tsift.extract_patches(field, lvl, y0, x0, patch_y=P + 8, patch_x=P))
        got = tsift.compute_orientations(
            gauss, kt, sampler=tsift._make_patch_sampler(patches, y0, x0, H, W))
    assert int(np.asarray(kj.valid).sum()) > 50
    d = np.abs(np.angle(np.exp(1j * (got.numpy().astype(np.float64) - want))))
    assert got.shape == want.shape == (256,) and np.all(np.isfinite(got.numpy()))
    assert float(d.max()) <= 2e-6, (float(d.max()), int((d > 2e-6).sum()))
