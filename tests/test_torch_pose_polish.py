"""PnP's IRLS Gauss-Newton pose polish: csrc/pose_polish.cu against its
plain version (ops/pose_polish.py).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has a GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pose_polish.py

Here, without a card, the `cuda` tests skip; the plain version, the
wrapper's checks and the step's one call per tracking frame run everywhere.
"""

import numpy as np
import pytest
import torch

from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core import init_state, make_step_fn
from visualodometry_tpu_torch.core.step import StepParts
from visualodometry_tpu_torch.data.synthetic import (
    K_DEFAULT,
    make_pnp_problem,
    make_scene,
    render_fixture_u8,
)
from visualodometry_tpu_torch.estimation import pnp
from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn
from visualodometry_tpu_torch.geometry.so3 import so3_log
from visualodometry_tpu_torch.ops import _build
from visualodometry_tpu_torch.ops import pose_polish as pp
from visualodometry_tpu_torch.utils import profiling

# the benchmark configurations' polish: pnp_irls_delta 1, pnp_irls_cut 3,
# pnp_reproj_err 2, 3 rounds of 8 + 3 + 3 iterations
DELTA, CUT_SQ, ROUNDS, ITERS = 2.0, 36.0, 3, 8

# Largest gaps of the kernel's pose to the plain version's on one card:
# 1e-6 rad of rotation and 3e-5 of the translation's length. The two sum
# over the points in other orders (csrc/pose_polish.cu); on an H100 at
# 2048 and 4096 points with 30% outliers they met within 1.3e-8 rad and
# 2.7e-6, where the plain version on the card and on the CPU differ by as
# much (1.4e-6). Stopping after one iteration of the 14 misses the plain
# pose by 1.1e-5 rad and 9.7e-5 or more, so a wrong Jacobian entry, weight,
# damping or update does not pass.
ROT_TOL, TRANS_TOL = 1e-6, 3e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _problem(n: int, outliers: float, seed: int, device="cpu"):
    """`make_pnp_problem` as tensors on `device`: (T_true, T0, X, uv,
    valid, K)."""
    *arrays, valid = make_pnp_problem(n, outliers, seed)
    return (*(torch.as_tensor(a, device=device) for a in arrays),
            torch.as_tensor(valid, device=device), torch.as_tensor(K_DEFAULT, device=device))


def _old_loop(T0, X, uv, valid, K):
    """`_finish_pnp`'s polish as it was written before ops/pose_polish.py:
    the reweighting and `refine_pose_gn`, round by round."""
    T_out = T0
    for rnd in range(max(1, ROUNDS)):
        err_sq_r, z_r = pnp._reproj_err_sq(T_out[:3, :3], T_out[:3, 3], X, uv, K)
        r = torch.sqrt(torch.clamp(err_sq_r, min=1e-12))
        w = torch.clamp(DELTA / r, max=1.0) * (err_sq_r < CUT_SQ) * valid * (z_r > 0)
        iters = ITERS if rnd == 0 else max(3, ITERS // 3)
        T_out = pnp.refine_pose_gn(T_out, X, uv, w, K, iters)
    return T_out


def _polish(T0, X, uv, valid, K, rounds=ROUNDS, iters=ITERS):
    return pp.polish_pose(T0, X, uv, valid, K, delta=DELTA, cut_sq=CUT_SQ, rounds=rounds,
                          iters=iters)


def _pose_gaps(Ta, Tb):
    """Rotation angle between two poses (rad) and their translations' gap
    over the second's length."""
    Ta, Tb = Ta.double().cpu(), Tb.double().cpu()
    rot = float(torch.linalg.vector_norm(so3_log(Ta[:3, :3] @ Tb[:3, :3].T)))
    trans = float(torch.linalg.vector_norm(Ta[:3, 3] - Tb[:3, 3])
                  / torch.linalg.vector_norm(Tb[:3, 3]))
    return rot, trans


@pytest.mark.parametrize("outliers", [0.0, 0.3])
@pytest.mark.parametrize("n", [64, 2048, 4096])
def test_cpu_polish_is_the_old_loop(n, outliers):
    """On CPU tensors `polish_pose` is the loop `_finish_pnp` ran before,
    bit for bit."""
    _, T0, X, uv, valid, K = _problem(n, outliers, seed=n)
    assert torch.equal(_polish(T0, X, uv, valid, K), _old_loop(T0, X, uv, valid, K))


def test_cpu_counts_no_launch():
    """The plain version launches nothing: no count in the module, none in
    the program's recorder."""
    _, T0, X, uv, valid, K = _problem(256, 0.3, seed=1)
    before = pp.launches
    profiling.enable(True)
    _polish(T0, X, uv, valid, K)
    assert pp.launches == before and "pose_polish.launch" not in profiling.summary()


@pytest.mark.parametrize("outliers", [0.0, 0.3])
def test_plain_polish_converges(outliers):
    """The plain version, the kernel's contract, brings a start pose ~3e-3
    rad and ~1.5% of the translation off to within 2e-4 rad and 0.2% of
    the true pose, through 30% outliers."""
    T_true, T0, X, uv, valid, K = _problem(2048, outliers, seed=5)
    rot0, trans0 = _pose_gaps(T0, T_true)
    rot, trans = _pose_gaps(_polish(T0, X, uv, valid, K), T_true)
    assert rot0 > 1e-3 and trans0 > 5e-3
    assert rot < 2e-4 and trans < 2e-3, (rot, trans)


@pytest.mark.parametrize("case", ["invalid", "behind", "beyond_cut", "no_iterations"])
def test_zero_weights_or_iterations_keep_the_pose(case):
    """With every weight zero (no valid point, every point behind the
    camera, every residual past the cut), or one round of no iterations
    (later rounds run max(3, iters // 3)), the pose comes back unchanged."""
    _, T0, X, uv, valid, K = _problem(128, 0.0, seed=2)
    rounds = ROUNDS
    if case == "invalid":
        valid = torch.zeros_like(valid)
    elif case == "behind":
        X = X * torch.tensor([1.0, 1.0, -1.0])
    elif case == "beyond_cut":
        uv = uv + 100.0
    else:
        rounds = 1
    iters = 0 if case == "no_iterations" else ITERS
    assert torch.equal(_polish(T0, X, uv, valid, K, rounds=rounds, iters=iters), T0)


def _bad_inputs():
    _, T0, X, uv, valid, K = _problem(16, 0.0, seed=4)
    meta = {k: v.to("meta") for k, v in dict(T0=T0, X=X, uv=uv, valid=valid, K=K).items()}
    return {
        "T0 shape": (ValueError, (T0[:3], X, uv, valid, K)),
        "X shape": (ValueError, (T0, X[:, :2], uv, valid, K)),
        "uv length": (ValueError, (T0, X, uv[:8], valid, K)),
        "valid length": (ValueError, (T0, X, uv, valid[:8], K)),
        "K shape": (ValueError, (T0, X, uv, valid, K[:2])),
        "batched X": (ValueError, (T0, X[None], uv, valid, K)),
        "valid dtype": (TypeError, (T0, X, uv, valid.float(), K)),
        "mixed devices": (ValueError, (T0, meta["X"], uv, valid, K)),
        "float64 off the CPU": (TypeError, tuple(
            meta[k].double() if k != "valid" else meta[k] for k in meta)),
        "unsupported device": (ValueError, tuple(meta.values())),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_checks_inputs(case):
    err, args = _bad_inputs()[case]
    with pytest.raises(err):
        _polish(*args)


def test_source_is_built():
    assert "pose_polish" in _build.KERNEL_SOURCES
    src = (_build.CSRC / "pose_polish.cu").read_text()
    assert "extern \"C\" int pose_polish_launch" in src


def _drive_config():
    return VOConfig(
        extractor_type="sift", image_size=(192, 112), max_keypoints=256, sift_n_features=256,
        sift_contrast_threshold=0.02, sift_num_octaves=3, min_median_flow=3.0,
        max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0, min_parallax_deg=0.35,
        lowe_ratio=0.8, essential_hypotheses=64, pnp_hypotheses=64, map_capacity=2048, seed=3,
    )


def _step_drive(device, monkeypatch):
    """An 8-frame 192x112 drive through `make_step_fn` on `device`, the
    recorder on; returns (tracking frames, polish calls, the recorder's
    `pose_polish.launch`)."""
    scene = make_scene(np.random.default_rng(7), num_frames=8, speed=1.2, turn_rate=0.002,
                       num_landmarks=2, image_size=(192, 112))
    cfg = _drive_config()
    calls = {"track": 0, "polish": 0}
    track, polish = StepParts.track, pnp.polish_pose

    def counted_track(*a, **k):
        calls["track"] += 1
        return track(*a, **k)

    def counted_polish(*a, **k):
        calls["polish"] += 1
        return polish(*a, **k)

    monkeypatch.setattr(StepParts, "track", counted_track)
    monkeypatch.setattr(pnp, "polish_pose", counted_polish)
    extract = make_batched_extract_fn(cfg, device=device)
    step = make_step_fn(cfg, scene.K, device=device)
    state = init_state(cfg, desc_dim=128, device=device)
    profiling.enable(True)
    for f in extract(torch.as_tensor(render_fixture_u8(scene), device=device)):
        state, _ = step(state, f)
    launched = profiling.summary().get("pose_polish.launch", {}).get("count", 0)
    return calls["track"], calls["polish"], launched


def test_step_polishes_once_per_tracking_frame_on_the_cpu(monkeypatch):
    tracked, polished, launched = _step_drive(torch.device("cpu"), monkeypatch)
    assert tracked >= 2 and polished == tracked and launched == 0


def _card_gaps(T0, X, uv, valid, K):
    Tk = _polish(T0, X, uv, valid, K)
    Tp = pp._polish_pose_torch(T0, X, uv, valid, K, DELTA, CUT_SQ, ROUNDS, ITERS)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Tk).all())
    return _pose_gaps(Tk, Tp)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [2048, 4096])
def test_kernel_matches_plain(cuda_device, n, seed):
    """Within ROT_TOL and TRANS_TOL of the plain version on the same card,
    at 30% outliers, 3 rounds of 8 + 3 + 3 iterations."""
    _, T0, X, uv, valid, K = _problem(n, 0.3, seed=100 * n + seed, device=cuda_device)
    rot, trans = _card_gaps(T0, X, uv, valid, K)
    assert rot <= ROT_TOL and trans <= TRANS_TOL, (rot, trans)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 511, 513, 20000])
def test_kernel_ragged_and_large_n(cuda_device, n):
    """A point count off the block's 512 threads, none at all, and one past
    the 48 KB of shared memory a launch gets unasked."""
    _, T0, X, uv, valid, K = _problem(n, 0.3, seed=n, device=cuda_device)
    rot, trans = _card_gaps(T0, X, uv, valid, K)
    assert rot <= ROT_TOL and trans <= TRANS_TOL, (rot, trans)


@pytest.mark.cuda
def test_kernel_zero_weights_keep_the_pose(cuda_device):
    _, T0, X, uv, valid, K = _problem(4096, 0.0, seed=6, device=cuda_device)
    out = _polish(T0, X, uv, torch.zeros_like(valid), K)
    assert torch.equal(out, T0)


@pytest.mark.cuda
def test_kernel_repeats_counts_and_adds_no_sync(cuda_device):
    """Two calls bit-equal; one launch counted a call, in the module and in
    the recorder; no host read; float64 and non-contiguous inputs, and more
    points than the kernel's shared memory holds, refused."""
    _, T0, X, uv, valid, K = _problem(4096, 0.3, seed=7, device=cuda_device)
    before = pp.launches
    profiling.enable(True)
    a = _polish(T0, X, uv, valid, K)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = _polish(T0, X, uv, valid, K)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, b)
    assert pp.launches == before + 2
    assert profiling.summary()["pose_polish.launch"]["count"] == 2
    with pytest.raises(TypeError):
        _polish(T0.double(), X.double(), uv.double(), valid, K.double())
    with pytest.raises(ValueError, match="contiguous"):
        _polish(T0.T.contiguous().T, X, uv, valid, K)
    _, T0, X, uv, valid, K = _problem(pp.MAX_POINTS + 1, 0.3, seed=8, device=cuda_device)
    with pytest.raises(ValueError, match="holds"):
        _polish(T0, X, uv, valid, K)


@pytest.mark.cuda
def test_step_launches_once_per_tracking_frame_on_the_card(cuda_device, monkeypatch):
    tracked, polished, launched = _step_drive(cuda_device, monkeypatch)
    assert tracked >= 2 and polished == tracked and launched == tracked
