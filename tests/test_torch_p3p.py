"""The P3P minimal solver: csrc/p3p.cu against its plain version
(estimation/p3p.py `_p3p_grunert_torch`).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has a GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_p3p.py

Here, without a card, the `cuda` tests skip; the plain version, the
wrapper's checks, the negative controls' visibility and the step's one
call per tracking frame run everywhere.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from visualodometry_tpu_torch import config_from_dict
from visualodometry_tpu_torch.core import init_state, make_step_fn
from visualodometry_tpu_torch.core.step import StepParts
from visualodometry_tpu_torch.data.synthetic import (
    K_DEFAULT,
    make_pnp_problem,
    make_scene,
    render_fixture_u8,
)
from visualodometry_tpu_torch.estimation import p3p, pnp
from visualodometry_tpu_torch.estimation.ransac import sample_valid_indices
from visualodometry_tpu_torch.frontend.superpoint import make_batched_superpoint_extract_fn
from visualodometry_tpu_torch.geometry.camera import pixels_to_normalized
from visualodometry_tpu_torch.geometry.so3 import so3_log
from visualodometry_tpu_torch.ops import _build
from visualodometry_tpu_torch.ops import p3p as p3p_ops
from visualodometry_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent

# The kernel against the plain version on the same card, over the 4H slots
# of triples drawn as the SuperPoint cell draws them (2048 points, 30%
# outliers). The card's plain version forms its complex products and
# quotients, its norms and its 3x3 products with the fused multiply-adds
# that the kernel repeats, yet their last bits still part (~50% of the
# slots bit-equal), and Durand-Kerner amplifies a last bit near a double
# root. So the bounds, each beside what the card gave (H100 80GB HBM3,
# PyTorch 2.11 + CUDA 12.8; 8 calls at H = 512, 4 at 4096, 8 at 37, 16 at
# 1, 2 at 256):
# - `ok` differs only at a root whose nearest other root of its sample
#   (the plain version's) lies within DOUBLE_ROOT_SEP: there the gates
#   (|Im| against 1e-3 (1 + |v|), u > 1e-6 from a quotient that vanishes
#   with the root gap) are decided by rounding. Measured: 9 mismatches in
#   85,216 slots, every one within 0.031 of another root;
# - every slot both call `ok` agrees within GAP_MAX (ROADMAP C's known
#   near-double-root gap) in R and in t over max(|t|, 1) with a candidate
#   the plain version calls `ok` in its sample, or sits at such a root, or
#   fits its own three points no worse than the plain pose (RES_FLOOR, or
#   twice the plain residual). Measured: 0.1% of the slots
#   beyond 3e-3, up to 1.7 where two near roots trade slots, and 0.116 at
#   a well-separated root whose pose fits its triple as the plain one does;
# - at least CLOSE_MIN of the slots both call `ok` agree within 1e-4, with
#   one slot to spare, where a call has CLOSE_FROM such slots or more (a
#   share of fewer is one slot's noise). Measured: 0.990-0.997 a call at
#   H = 256-4096 (0.99384 and 0.99393 pooled at 512 and 4096). The
#   39-iteration control read 0.970-0.982 a call (0.977 pooled), Jacobi
#   order 0.40 with `ok` differing in 35% of the slots, and each fails.
DOUBLE_ROOT_SEP, GAP_MAX, RES_FLOOR = 0.05, 3e-3, 1e-4
CLOSE_MIN, CLOSE_FROM = 0.985, 256
# Against the plain version on the CPU, whose complex quotient, reductions
# and products round otherwise: the card's own plain version agrees with
# it in 0.886-0.925 of the slots both call `ok` and differs in `ok` in up
# to 1.4% of the slots (H = 37). The kernel is held to stand no farther
# from it than the card's plain version: at most CPU_SLACK more of those
# slots outside 1e-4 and CPU_SLACK / 10 more of the slots with another
# `ok`, each with one slot to spare. Measured: at most 2 more slots of 703
# outside 1e-4, no more with another `ok`.
CPU_SLACK = 0.01


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


def _triples(H: int, seed: int, device="cpu"):
    """H minimal samples of `make_pnp_problem`'s correspondences (2048
    points, 30% outliers), drawn with replacement as RANSAC draws them:
    X (H, 3, 3) and normalized xy (H, 3, 2)."""
    _, _, X, uv, valid = make_pnp_problem(2048, 0.3, seed)
    X, uv, valid = torch.as_tensor(X), torch.as_tensor(uv), torch.as_tensor(valid)
    idx = sample_valid_indices(torch.Generator().manual_seed(seed), valid, H, 3)
    xy = pixels_to_normalized(uv, torch.as_tensor(K_DEFAULT))
    return X[idx].contiguous().to(device), xy[idx].contiguous().to(device)


def _degenerate():
    """Collinear world points, a repeated point and one sound triple, in
    values float32 holds exactly: the triads of the first two are NaN."""
    X = torch.tensor([[[0.0, 0.0, 10.0], [1.0, 0.0, 10.0], [2.0, 0.0, 10.0]],
                      [[0.0, 0.0, 10.0], [0.0, 0.0, 10.0], [1.0, 1.0, 12.0]],
                      [[1.0, 2.0, 10.0], [3.0, 1.0, 12.0], [-2.0, 0.0, 9.0]]])
    xy = torch.tensor([[[0.0, 0.0], [0.1, 0.0], [0.2, 0.0]],
                       [[0.0, 0.0], [0.0, 0.0], [0.1, 0.1]],
                       [[0.1, 0.2], [0.25, 0.08], [-0.22, 0.0]]])
    return X, xy


def _same(a, b):
    """Elementwise bit equality that takes NaN as equal to NaN."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def _triple_residual(R, t, X, xy):
    """Largest normalized reprojection error of each candidate on its own
    three points, (H, 4), in float64."""
    p = torch.einsum("hcij,hnj->hcni", R.double(), X.double()) + t.double()[:, :, None, :]
    return (p[..., :2] / p[..., 2:] - xy.double()[:, None]).abs().amax((-1, -2))


def _plain_roots(X, xy):
    """The plain version's (R, t, ok) on X's device, and for each of the 4H
    slots the distance from its Durand-Kerner root to the nearest other
    root of the sample, (H, 4) on the CPU."""
    seen, dk = {}, p3p._durand_kerner4

    def recorded(coeffs, iters=40):
        seen["z"] = dk(coeffs, iters)
        return seen["z"]

    p3p._durand_kerner4 = recorded
    try:
        out = p3p._p3p_grunert_torch(X, xy)
    finally:
        p3p._durand_kerner4 = dk
    z = seen["z"].cpu()
    gap = (z[:, :, None] - z[:, None, :]).abs()
    return out, gap.masked_fill(torch.eye(4, dtype=torch.bool), torch.inf).amin(-1)


def _agreement(out, ref, X, xy, sep=None) -> dict:
    """How far a solver's (R, t, ok) is from the reference's, slot by slot;
    `sep` (H, 4), the reference's root separations, marks the slots at a
    near-double root."""
    (Ra, ta, oka), (Rb, tb, okb) = ([v.cpu() for v in o] for o in (out, ref))
    X, xy = X.cpu(), xy.cpu()
    both = oka & okb
    near = torch.zeros_like(both) if sep is None else sep < DOUBLE_ROOT_SEP
    equal = _same(Ra, Rb).all(-1).all(-1) & _same(ta, tb).all(-1) & (oka == okb)
    scale = torch.clamp(torch.linalg.vector_norm(tb, dim=-1), min=1.0)
    gap = torch.maximum((Ra - Rb).abs().amax((-1, -2)), (ta - tb).abs().amax(-1) / scale)
    # to the nearest candidate the reference calls `ok` in the sample: two
    # roots may trade slots
    pair = torch.maximum((Ra[:, :, None] - Rb[:, None]).abs().amax((-1, -2)),
                         (ta[:, :, None] - tb[:, None]).abs().amax(-1) / scale[:, None])
    nearest = torch.where(okb[:, None], pair, torch.inf).amin(-1)
    res_a, res_b = _triple_residual(Ra, ta, X, xy), _triple_residual(Rb, tb, X, xy)
    worse = res_a > torch.clamp(2.0 * res_b, min=RES_FLOOR)
    nan_a, nan_b = torch.isnan(Ra).any(-1).any(-1), torch.isnan(Rb).any(-1).any(-1)
    return dict(
        n=int(oka.numel()), both=int(both.sum()), bit_eq=float(equal.float().mean()),
        ok_mis=int((oka != okb).sum()),
        ok_mis_apart=int(((oka != okb) & ~near).sum()),
        far=int((both & (nearest > GAP_MAX) & ~near & worse).sum()),
        nonclose=int((both & ~(gap < 1e-4)).sum()),
        nan_mis_ok=int(((nan_a != nan_b) & (oka | okb)).sum()),
    )


def _card_agrees(m: dict) -> bool:
    close = m["both"] < CLOSE_FROM or m["nonclose"] <= (1.0 - CLOSE_MIN) * m["both"] + 1
    return m["ok_mis_apart"] == 0 and m["far"] == 0 and m["nan_mis_ok"] == 0 and close


def _cpu_agrees(kernel: dict, card: dict) -> bool:
    """The kernel stands no farther from the CPU's plain version than the
    card's plain version does."""
    return (kernel["nonclose"] <= card["nonclose"] + CPU_SLACK * kernel["both"] + 1
            and kernel["ok_mis"] <= card["ok_mis"] + CPU_SLACK / 10 * kernel["n"] + 1
            and kernel["nan_mis_ok"] <= card["nan_mis_ok"])


def _jacobi(coeffs, iters=40):
    """Durand-Kerner with every root updated from the previous iteration's
    roots (Jacobi order): the control for a kernel that loses the
    Gauss-Seidel order."""
    c4 = coeffs[..., 4:5]
    mon = coeffs / torch.where(c4.abs() > 1e-12, c4, 1e-12)
    z = list(p3p._constants(coeffs.device)[2].expand(coeffs.shape[:-1] + (4,)).unbind(-1))
    for _ in range(iters):
        new = []
        for i in range(4):
            denom = torch.ones_like(z[i])
            for j in range(4):
                if j != i:
                    denom = denom * (z[i] - z[j])
            denom = torch.where(denom.abs() > 1e-12, denom, 1e-12)
            r = torch.zeros_like(z[i])
            for k in range(4, -1, -1):
                r = r * z[i] + mon[..., k]
            new.append(z[i] - r / denom)
        z = new
    return torch.stack(z, dim=-1)


CONTROLS = {
    "39 iterations": functools.partial(p3p._durand_kerner4, iters=39),
    "Jacobi order": _jacobi,
}


def _control(name, X, xy, monkeypatch):
    """The plain version with its Durand-Kerner replaced by a control."""
    with monkeypatch.context() as m:
        m.setattr(p3p, "_durand_kerner4", CONTROLS[name])
        return p3p._p3p_grunert_torch(X, xy)


@pytest.mark.parametrize("H,seed", [(512, 1), (256, 2), (37, 3), (1, 4)])
def test_cpu_route_is_the_old_function(H, seed):
    """On CPU tensors `p3p_grunert` is the function it was before the
    kernel, bit for bit: the benchmark's reference holds a frozen copy of
    it (vobench/reference/estimation/p3p.py)."""
    from vobench.reference.estimation.p3p import p3p_grunert as old

    X, xy = _triples(H, seed)
    for a, b in zip(p3p.p3p_grunert(X, xy), old(X, xy)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(_same(a, b).all())


def test_cpu_counts_no_launch():
    """The plain version launches nothing: no count in the module, none in
    the program's recorder."""
    X, xy = _triples(64, 5)
    before = p3p_ops.launches
    profiling.enable(True)
    p3p.p3p_grunert(X, xy)
    assert p3p_ops.launches == before and "p3p.launch" not in profiling.summary()


def test_plain_recovers_the_true_pose():
    """The plain version, the kernel's contract: on samples of inliers
    (0.5 px of noise, points 4-60 m away), the best of the four candidates
    is within 0.01 rad of the true rotation and 0.3 m of the true camera
    centre for the median sample, within 0.05 rad for most."""
    T_true, _, X, uv, valid = make_pnp_problem(512, 0.0, seed=6)
    xy = pixels_to_normalized(torch.as_tensor(uv), torch.as_tensor(K_DEFAULT))
    idx = torch.as_tensor(np.random.default_rng(6).choice(512, (64, 3)))
    R, t, ok = p3p.p3p_grunert(torch.as_tensor(X)[idx].contiguous(), xy[idx].contiguous())
    R_true, t_true = torch.as_tensor(T_true[:3, :3]), torch.as_tensor(T_true[:3, 3])
    rot = torch.linalg.vector_norm(so3_log(R @ R_true.T), dim=-1)
    centre = torch.linalg.vector_norm(
        torch.einsum("hcji,hcj->hci", R, t) - R_true.T @ t_true, dim=-1)
    rot = torch.where(ok, rot, torch.inf).amin(-1)
    centre = torch.where(ok, centre, torch.inf).amin(-1)
    assert float(rot.median()) < 0.01 and float(centre.median()) < 0.3
    assert float((rot < 0.05).float().mean()) > 0.8


def test_plain_degenerate_triples_give_no_pose():
    """Collinear world points and a repeated point: no candidate is `ok`,
    and the collinear triple's poses are NaN in every slot."""
    X, xy = _degenerate()
    R, t, ok = p3p.p3p_grunert(X, xy)
    assert not bool(ok[:2].any()) and bool(ok[2].any())
    assert bool(torch.isnan(R[0]).all(-1).all(-1).all()) and bool(torch.isnan(t[0]).all())


@pytest.mark.parametrize("name", list(CONTROLS))
def test_controls_fail_the_card_bounds_on_the_cpu(name, monkeypatch):
    """A kernel that ran one Durand-Kerner iteration short, or in Jacobi
    order, would not pass: each control, against the plain version on the
    same device, falls outside the bounds the kernel is held to."""
    X, xy = _triples(512, 7)
    ref, sep = _plain_roots(X, xy)
    m = _agreement(_control(name, X, xy, monkeypatch), ref, X, xy, sep)
    assert not _card_agrees(m), m


def _bad_inputs():
    X, xy = _triples(8, 8)
    meta_X, meta_xy = X.to("meta"), xy.to("meta")
    return {
        "float64": (TypeError, (X.double(), xy.double())),
        "X shape": (ValueError, (X[:, :2], xy)),
        "xy shape": (ValueError, (X, xy[..., :1])),
        "sample counts": (ValueError, (X, xy[:4])),
        "unbatched": (ValueError, (X[0], xy[0])),
        "non-contiguous": (ValueError, (X.transpose(1, 2).contiguous().transpose(1, 2), xy)),
        "mixed devices": (ValueError, (X, meta_xy)),
        "unsupported device": (ValueError, (meta_X, meta_xy)),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_checks_inputs(case):
    err, args = _bad_inputs()[case]
    with pytest.raises(err):
        p3p.p3p_grunert(*args)


def test_source_is_built():
    assert "p3p" in _build.KERNEL_SOURCES
    assert "p3p_launch" in _build.ENTRY_POINTS["p3p"]
    assert "extern \"C\" int p3p_launch" in (_build.CSRC / "p3p.cu").read_text()


def _step_drive(device, monkeypatch):
    """An 8-frame 320x192 drive through `make_step_fn` with the SuperPoint
    cell's `vo_config` (vobench/configs/superpoint_kitti.json: P3P PnP), its
    slots, hypotheses and map cut to the frame, the recorder on; returns
    (tracking frames, P3P calls, the recorder's `p3p.launch`)."""
    vo = json.loads((ROOT / "vobench/configs/superpoint_kitti.json").read_text())["vo_config"]
    cfg = config_from_dict(dict(vo, image_size=[320, 192], max_keypoints=512,
                                essential_hypotheses=64, pnp_hypotheses=64,
                                map_capacity=4096, seed=3))
    assert cfg.pnp_solver == "p3p"
    scene = make_scene(np.random.default_rng(7), num_frames=8, speed=1.2, turn_rate=0.002,
                       num_landmarks=2, image_size=(320, 192))
    calls = {"track": 0, "p3p": 0}
    track, solve = StepParts.track, pnp.p3p_grunert

    def counted_track(*a, **k):
        calls["track"] += 1
        return track(*a, **k)

    def counted_p3p(*a, **k):
        calls["p3p"] += 1
        return solve(*a, **k)

    monkeypatch.setattr(StepParts, "track", counted_track)
    monkeypatch.setattr(pnp, "p3p_grunert", counted_p3p)
    extract = make_batched_superpoint_extract_fn(cfg, device=device)
    step = make_step_fn(cfg, scene.K, device=device)
    state = init_state(cfg, desc_dim=256, device=device)
    profiling.enable(True)
    for f in extract(torch.as_tensor(render_fixture_u8(scene), device=device)):
        state, _ = step(state, f)
    launched = profiling.summary().get("p3p.launch", {}).get("count", 0)
    return calls["track"], calls["p3p"], launched


def test_step_calls_p3p_once_per_tracking_frame_on_the_cpu(monkeypatch):
    tracked, solved, launched = _step_drive(torch.device("cpu"), monkeypatch)
    assert tracked >= 2 and solved == tracked and launched == 0


@pytest.mark.cuda
@pytest.mark.parametrize("H,seed", [(512, 11), (512, 12), (1, 13), (37, 14), (4096, 15)])
def test_kernel_matches_plain(cuda_device, H, seed):
    """Within the card bounds of the plain version on the same card, and
    no farther from the plain version on the CPU than the card's plain
    version is."""
    X, xy = _triples(H, seed)
    Xd, xyd = X.to(cuda_device), xy.to(cuda_device)
    out = p3p.p3p_grunert(Xd, xyd)
    plain, sep = _plain_roots(Xd, xyd)
    card = _agreement(out, plain, X, xy, sep)
    cpu_ref = p3p._p3p_grunert_torch(X, xy)
    cpu, card_cpu = _agreement(out, cpu_ref, X, xy), _agreement(plain, cpu_ref, X, xy)
    assert _card_agrees(card), card
    assert _cpu_agrees(cpu, card_cpu), (cpu, card_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONTROLS))
def test_controls_fail_the_card_bounds(cuda_device, name, monkeypatch):
    """The controls, run on the card against the plain version there, fall
    outside the bounds the kernel meets."""
    X, xy = _triples(4096, 16, cuda_device)
    ref, sep = _plain_roots(X, xy)
    m = _agreement(_control(name, X, xy, monkeypatch), ref, X, xy, sep)
    assert not _card_agrees(m), m


@pytest.mark.cuda
def test_kernel_degenerate_triples(cuda_device):
    """Collinear and repeated points: no candidate `ok`, and NaN in the
    same slots as the plain version on the card and on the CPU."""
    X, xy = _degenerate()
    R, t, ok = (v.cpu() for v in p3p.p3p_grunert(X.to(cuda_device), xy.to(cuda_device)))
    for ref in (p3p._p3p_grunert_torch(X.to(cuda_device), xy.to(cuda_device)),
                p3p._p3p_grunert_torch(X, xy)):
        Rr, tr, okr = (v.cpu() for v in ref)
        assert torch.equal(ok, okr)
        assert torch.equal(torch.isnan(R), torch.isnan(Rr))
        assert torch.equal(torch.isnan(t), torch.isnan(tr))
    assert not bool(ok[:2].any())


@pytest.mark.cuda
def test_kernel_repeats_counts_and_adds_no_sync(cuda_device):
    """Two calls bit-equal; one launch counted a call, in the module and in
    the recorder; no host read; no samples, no launch."""
    X, xy = _triples(512, 17, cuda_device)
    before = p3p_ops.launches
    profiling.enable(True)
    a = p3p.p3p_grunert(X, xy)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = p3p.p3p_grunert(X, xy)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(_same(u, v).all()) for u, v in zip(a, b))
    assert p3p_ops.launches == before + 2
    assert profiling.summary()["p3p.launch"]["count"] == 2
    R, t, ok = p3p.p3p_grunert(X[:0], xy[:0])
    assert R.shape == (0, 4, 3, 3) and t.shape == (0, 4, 3) and ok.shape == (0, 4)
    assert p3p_ops.launches == before + 2


@pytest.mark.cuda
def test_step_launches_once_per_tracking_frame_on_the_card(cuda_device, monkeypatch):
    tracked, solved, launched = _step_drive(cuda_device, monkeypatch)
    assert tracked >= 2 and solved == tracked and launched == tracked
