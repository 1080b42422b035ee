"""Port RANSAC estimators vs JAX on identical minimal samples.

The JAX estimators draw their samples from a PRNG key inside; the port's
take them explicitly. Each test draws the indices with JAX's own
`sample_valid_indices` and the same key the JAX estimator uses, and hands
them to the port, so both score the same hypotheses. Remaining
differences are float32 operation order; the refinements converge to the
same data-determined optimum, hence the 1e-4-class tolerances.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.estimation import essential as jess
from visualodometry_tpu.estimation import fivepoint as jfive
from visualodometry_tpu.estimation import p3p as jp3p
from visualodometry_tpu.estimation import pnp as jpnp
from visualodometry_tpu.estimation.ransac import sample_valid_indices as jsample
from visualodometry_tpu.geometry.se3 import se3_exp
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.estimation import essential as tess
from visualodometry_tpu_torch.estimation import fivepoint as tfive
from visualodometry_tpu_torch.estimation import p3p as tp3p
from visualodometry_tpu_torch.estimation import pnp as tpnp
from visualodometry_tpu_torch.estimation.ransac import sample_valid_indices

torch.set_num_threads(2)

K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 96.0], [0.0, 0.0, 1.0]], np.float32)
N = 240


def _t(x):
    return torch.as_tensor(np.array(x))


def _cfgs(**kw):
    jc = JaxConfig(essential_hypotheses=64, pnp_hypotheses=64, pnp_reproj_err=2.0, **kw)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _project(X, T_cw):
    p = X @ T_cw[:3, :3].T + T_cw[:3, 3]
    uv = p[:, :2] / p[:, 2:]
    return (uv * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    X = np.stack(
        [rng.uniform(-6, 6, N), rng.uniform(-2, 2, N), rng.uniform(5, 40, N)], 1
    ).astype(np.float32)
    T1 = np.asarray(se3_exp(jnp.asarray([0.05, 0.0, -1.2, 0.0, 0.01, 0.0], jnp.float32)))
    uv0 = _project(X, np.eye(4, dtype=np.float32)) + rng.normal(0, 0.3, (N, 2)).astype(np.float32)
    uv1 = _project(X, T1) + rng.normal(0, 0.3, (N, 2)).astype(np.float32)
    out = rng.random(N) < 0.2
    uv1[out] = rng.uniform([0, 0], [640, 192], (out.sum(), 2)).astype(np.float32)
    valid = rng.random(N) > 0.05
    return X, T1, uv0, uv1, valid


def test_sample_valid_indices_draws_valid_entries():
    gen = torch.Generator().manual_seed(0)
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 11, 40]] = True
    idx = sample_valid_indices(gen, valid, 32, 6)
    assert idx.shape == (32, 6) and bool(valid[idx].all())
    assert set(idx.flatten().tolist()) == {3, 7, 11, 40}
    none = sample_valid_indices(gen, torch.zeros(5, dtype=torch.bool), 4, 3)
    assert int(none.abs().sum()) == 0


def _same_up_to_sign(a, b, atol):
    return min(np.abs(a - b).max(), np.abs(a + b).max()) < atol


def _samples(scene, n_hyp=32):
    X, T1, uv0, uv1, valid = scene
    x0 = (uv0 - K[:2, 2]) / K[0, 0]
    x1 = (uv1 - K[:2, 2]) / K[0, 0]
    idx = np.asarray(jsample(jax.random.key(1), jnp.asarray(~np.zeros(N, bool)), n_hyp, 5))
    return x0, x1, idx


def test_five_point_stages_match_jax(scene):
    """Each algebraic stage, fed the JAX stage's input, agrees with it.

    The 4-dim null space of the rank-5 normal matrix is extracted by
    shifted inverse iteration, which is ill-conditioned in float32; the
    port iterates in float64, so that stage is compared as a subspace (its
    projector), and on near-degenerate samples against numpy's float64."""
    x0, x1, idx = _samples(scene)
    a, b = x0[idx], x1[idx]
    rows = np.stack([b[..., 0] * a[..., 0], b[..., 0] * a[..., 1], b[..., 0],
                     b[..., 1] * a[..., 0], b[..., 1] * a[..., 1], b[..., 1],
                     a[..., 0], a[..., 1], np.ones_like(a[..., 0])], -1)
    AtA = np.einsum("hni,hnj->hij", rows, rows).astype(np.float32)
    Eb_j = np.asarray(jfive.null_basis(jnp.asarray(AtA), 4))
    Eb_t = tfive.null_basis(_t(AtA), 4).numpy()
    proj = lambda V: V @ np.swapaxes(V, -1, -2)  # noqa: E731
    # The port iterates in float64. Where the 4-dim null space is defined
    # at float32's shift (fifth eigenvalue above 1e-6 of the trace) both
    # agree to 1e-3; on a near-degenerate sample JAX's float32 basis can
    # be 1e-2 or more from the float64 one, and the port must be no
    # further from numpy's float64 basis than JAX is (a sample that
    # repeats a point has a 5-dim null space and no such basis).
    w, U = np.linalg.eigh(AtA.astype(np.float64))
    tr = np.trace(AtA, axis1=1, axis2=2)
    defined = w[:, 4] > 1e-6 * tr
    near = ~defined & np.array([len(set(r)) == 5 for r in idx])
    assert defined.sum() >= 28 and near.any()
    np.testing.assert_allclose(proj(Eb_t)[defined], proj(Eb_j)[defined], atol=1e-3)
    err = lambda V: np.abs(proj(V) - proj(U[..., :4])).max(axis=(1, 2))  # noqa: E731
    assert (err(Eb_t.astype(np.float64)) <= err(Eb_j.astype(np.float64)))[near].all()

    A_j = jfive._constraint_rows(jnp.asarray(Eb_j))
    A_t = tfive._constraint_rows(_t(Eb_j))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), rtol=1e-5, atol=1e-6)
    B_j = jfive._gauss_jordan_tail(A_j)
    B_t = tfive._gauss_jordan_tail(_t(np.asarray(A_j)))
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=1e-4, atol=1e-5)
    d_j = jfive._det_poly(jfive._action_polys(B_j))
    d_t = tfive._det_poly(tfive._action_polys(_t(np.asarray(B_j))))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-4, atol=1e-6)
    re_j, im_j = (np.asarray(v) for v in jfive._durand_kerner(d_j))
    re_t, im_t = (v.numpy() for v in tfive._durand_kerner(_t(np.asarray(d_j))))
    real = np.abs(im_j) <= 0.02 * (1.0 + np.abs(re_j))
    np.testing.assert_allclose(re_t[real], re_j[real], rtol=1e-3, atol=1e-3)


def test_null_basis_is_float64_grade(scene):
    """The port's null basis against numpy's float64 eigendecomposition of
    the normal matrix `five_point_candidates` forms (float64, from the
    float32 coordinates): projectors within 1e-5 on every sample whose
    4-dim null space is defined (fifth eigenvalue above 1e-9 of the trace;
    a sample that repeats a point has a 5-dim one). On every sample the
    basis is orthonormal and spans null vectors of the matrix."""
    x0, x1, idx = _samples(scene, n_hyp=256)
    a, b = x0[idx].astype(np.float64), x1[idx].astype(np.float64)
    rows = np.stack([b[..., 0] * a[..., 0], b[..., 0] * a[..., 1], b[..., 0],
                     b[..., 1] * a[..., 0], b[..., 1] * a[..., 1], b[..., 1],
                     a[..., 0], a[..., 1], np.ones_like(a[..., 0])], -1)
    AtA = np.einsum("hni,hnj->hij", rows, rows)
    V = tfive.null_basis(_t(AtA), 4).numpy()
    w, U = np.linalg.eigh(AtA)
    defined = w[:, 4] > 1e-9 * np.trace(AtA, axis1=1, axis2=2)
    assert defined.sum() >= 240
    proj = lambda V: V @ np.swapaxes(V, -1, -2)  # noqa: E731
    np.testing.assert_allclose(proj(V)[defined], proj(U[..., :4])[defined], atol=1e-5)
    np.testing.assert_allclose(np.swapaxes(V, -1, -2) @ V, np.broadcast_to(np.eye(4), (256, 4, 4)),
                               atol=1e-12)
    assert np.abs(AtA @ V).max() < 1e-9


def test_five_point_candidates_match_jax(scene):
    """End to end the null-space basis differs (see above), so candidates
    are matched as a set: most accepted JAX candidates have a port
    candidate from the same sample within 1e-3 (up to sign)."""
    x0, x1, idx = _samples(scene)
    E_j, ok_j = (np.asarray(v) for v in jax.jit(jfive.five_point_candidates)(
        jnp.asarray(x0[idx]), jnp.asarray(x1[idx])))
    E_t, ok_t = tfive.five_point_candidates(_t(x0[idx]), _t(x1[idx]))
    E_t, ok_t = E_t.numpy(), ok_t.numpy()
    found = [
        any(_same_up_to_sign(E_j[h, r], E_t[h, q], 1e-3) for q in np.flatnonzero(ok_t[h]))
        for h, r in zip(*np.nonzero(ok_j))
    ]
    assert len(found) > 32 and np.mean(found) >= 0.85, np.mean(found)
    assert abs(int(ok_t.sum()) - int(ok_j.sum())) <= 0.1 * ok_j.sum()


def test_refine_essential_manifold_matches_jax(scene):
    """The manifold GN refit (its Jacobian written out in the port,
    `jax.jacfwd` in JAX) on the same candidates and weights."""
    x0, x1, idx = _samples(scene)
    E_j, ok_j = (np.asarray(v) for v in jax.jit(jfive.five_point_candidates)(
        jnp.asarray(x0[idx[:4]]), jnp.asarray(x1[idx[:4]])))
    E = E_j[ok_j][:6]
    w = (np.random.default_rng(5).random((len(E), N)) > 0.3).astype(np.float32)
    ref_j = jax.vmap(lambda Ei, wi: jess.refine_essential_manifold(
        Ei, jnp.asarray(x0), jnp.asarray(x1), wi))(jnp.asarray(E), jnp.asarray(w))
    ref_t = tess.refine_essential_manifold(_t(E), _t(x0), _t(x1), _t(w))
    for a, b in zip(ref_t.numpy(), np.asarray(ref_j)):
        assert _same_up_to_sign(a, b, 1e-4)


def test_essential_ransac_and_recover_pose_match_jax(scene):
    """Whole RANSAC on identical samples: the candidate pools differ at
    the 1e-3 level (null-space basis, above), which can change the top-16
    refined set and with it the polished basin the MSAC cost selects. So
    the outcome is compared: the same inliers up to 3%, the recovered
    translation direction within 1 degree (the init pair's shallow
    direction, estimation/essential.py in the JAX package)."""
    X, T1, uv0, uv1, valid = scene
    jc, tc = _cfgs()
    key = jax.random.key(3)
    args_j = (jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), jnp.asarray(K))
    res_j = jax.jit(lambda a, b, v, k: jess.estimate_essential_ransac(a, b, v, k, jc, key))(*args_j)
    idx = jsample(key, jnp.asarray(valid), jc.essential_hypotheses, 5)
    res_t = tess.estimate_essential_ransac(
        _t(uv0), _t(uv1), _t(valid), _t(K), tc, _t(np.asarray(idx)).long()
    )
    assert bool(res_t.ok) and bool(res_j.ok)
    assert (res_t.inliers.numpy() != np.asarray(res_j.inliers)).sum() <= 0.03 * N

    # recoverPose itself, on the same E and inliers: exact
    R_j, t_j = jess.recover_pose(res_j.E, *args_j[:2], res_j.inliers, args_j[3])
    R_t, t_t = tess.recover_pose(
        _t(np.asarray(res_j.E)), _t(uv0), _t(uv1), _t(np.asarray(res_j.inliers)), _t(K)
    )
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    _, t_own = tess.recover_pose(res_t.E, _t(uv0), _t(uv1), res_t.inliers, _t(K))
    assert float(t_own.numpy() @ np.asarray(t_j)) > np.cos(np.deg2rad(1.0))
    t_true = T1[:3, 3] / np.linalg.norm(T1[:3, 3])
    assert float(t_own.numpy() @ t_true) > 0.99


def test_pnp_ransac_matches_jax(scene):
    X, T1, uv0, uv1, valid = scene
    jc, tc = _cfgs()
    key = jax.random.key(4)
    T_init = np.asarray(se3_exp(jnp.asarray([0.0, 0.0, -1.0, 0.0, 0.0, 0.0], jnp.float32)))
    res_j = jax.jit(lambda X_, u, v, k, Ti: jpnp.solve_pnp_ransac(X_, u, v, k, jc, key, T_init=Ti))(
        jnp.asarray(X), jnp.asarray(uv1), jnp.asarray(valid), jnp.asarray(K), jnp.asarray(T_init)
    )
    idx = jsample(key, jnp.asarray(valid), jc.pnp_hypotheses, 6)
    res_t = tpnp.solve_pnp_ransac(
        _t(X), _t(uv1), _t(valid), _t(K), tc, _t(np.asarray(idx)).long(), T_init=_t(T_init)
    )
    assert bool(res_t.ok) and bool(res_j.ok)
    np.testing.assert_allclose(res_t.T_cw.numpy(), np.asarray(res_j.T_cw), atol=1e-4)
    assert (res_t.inliers.numpy() != np.asarray(res_j.inliers)).sum() <= 2
    np.testing.assert_allclose(res_t.T_cw.numpy()[:3, 3], T1[:3, 3], atol=0.05)


def test_p3p_grunert_matches_jax(scene):
    """Identical (X, xy) triplets through both solvers. The four roots of
    a sample come out of Durand-Kerner in the same order (same seeds, same
    update order), so candidates are compared slot by slot: poses of
    candidates both call `ok` to 1e-4; the `ok` masks may differ only
    where a root sits at a gate (imaginary part, positivity), which is
    rare: at most 2% of the slots."""
    X, T1, _, uv1, _ = scene
    rng = np.random.default_rng(11)
    idx = rng.integers(0, N, (96, 3))
    xy = ((uv1 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    R_j, t_j, ok_j = (np.asarray(v) for v in jax.jit(jp3p.p3p_grunert)(
        jnp.asarray(X[idx]), jnp.asarray(xy[idx])))
    R_t, t_t, ok_t = (v.numpy() for v in tp3p.p3p_grunert(_t(X[idx]), _t(xy[idx])))
    assert R_t.shape == (96, 4, 3, 3) and t_t.shape == (96, 4, 3)
    assert (ok_t != ok_j).mean() <= 0.02
    both = ok_t & ok_j
    assert both.sum() > 96
    # Some triples are ill-conditioned (near-double roots): float32
    # operation order then moves the pose by ~1e-3 while both poses fit
    # their three points equally well. So: most candidates agree to 1e-4
    # in R (1e-3 in t, at 5-40 m depths), and every port candidate
    # reprojects its own triple as well as the JAX one does.
    close = (np.abs(R_t - R_j).max((-1, -2)) < 1e-4) & (np.abs(t_t - t_j).max(-1) < 1e-3)
    assert close[both].mean() >= 0.9, close[both].mean()

    def triple_residual(R, t):
        p = np.einsum("hcij,hnj->hcni", R, X[idx]) + t[:, :, None, :]
        return np.abs(p[..., :2] / p[..., 2:] - xy[idx][:, None]).max((-1, -2))

    res_t, res_j = triple_residual(R_t, t_t)[both], triple_residual(R_j, t_j)[both]
    assert (res_t <= np.maximum(1e-4, 2.0 * res_j)).all()
    # all-inlier samples (0.3 px noise): the best candidate is near the true pose
    inl = np.linalg.norm(_project(X, T1) - uv1, axis=1) < 1.0
    good = inl[idx].all(1)
    err = np.abs(t_t - T1[:3, 3]).max(-1)
    err[~ok_t] = np.inf
    assert good.sum() > 20 and np.median(err[good].min(1)) < 0.2


def test_pnp_ransac_p3p_matches_jax(scene):
    """`pnp_solver="p3p"` on identical sample indices: the hypothesis
    pools agree candidate by candidate (above), and the IRLS polish
    converges to the same data-determined optimum: pose to 1e-4, inlier
    sets equal up to 2 borderline points."""
    X, T1, uv0, uv1, valid = scene
    jc, tc = _cfgs(pnp_solver="p3p")
    key = jax.random.key(6)
    T_init = np.asarray(se3_exp(jnp.asarray([0.0, 0.0, -1.0, 0.0, 0.0, 0.0], jnp.float32)))
    res_j = jax.jit(lambda X_, u, v, k, Ti: jpnp.solve_pnp_ransac(X_, u, v, k, jc, key, T_init=Ti))(
        jnp.asarray(X), jnp.asarray(uv1), jnp.asarray(valid), jnp.asarray(K), jnp.asarray(T_init)
    )
    idx = jsample(key, jnp.asarray(valid), jc.pnp_hypotheses, 3)
    res_t = tpnp.solve_pnp_ransac(
        _t(X), _t(uv1), _t(valid), _t(K), tc, _t(np.asarray(idx)).long(), T_init=_t(T_init)
    )
    assert bool(res_t.ok) and bool(res_j.ok)
    assert abs(int(res_t.num_inliers) - int(res_j.num_inliers)) <= 2
    np.testing.assert_allclose(res_t.T_cw.numpy(), np.asarray(res_j.T_cw), atol=1e-4)
    assert (res_t.inliers.numpy() != np.asarray(res_j.inliers)).sum() <= 2
    np.testing.assert_allclose(res_t.T_cw.numpy()[:3, 3], T1[:3, 3], atol=0.05)


@pytest.mark.parametrize("which", ["p3p", "8point"])
def test_unported_solvers_raise(scene, which):
    """Each solver runs on a sample of its own size and raises, not falls
    back, on a sample of another size or an unknown solver name: P3P takes
    (H, 3), the eight-point essential solver (ported since the
    multi-sequence slice, whose parity tests pin it) (H, 8)."""
    X, _, uv0, uv1, valid = scene
    if which == "p3p":
        _, tc = _cfgs(pnp_solver="p3p")
        with pytest.raises(ValueError, match=r"\(H, 3\)"):
            tpnp.solve_pnp_ransac(_t(X), _t(uv1), _t(valid), _t(K), tc,
                                  torch.zeros(4, 6, dtype=torch.long))
        with pytest.raises(ValueError, match="unknown pnp_solver"):
            tpnp.solve_pnp_ransac(_t(X), _t(uv1), _t(valid), _t(K),
                                  tc.replace(pnp_solver="epnp"),
                                  torch.zeros(4, 3, dtype=torch.long))
    else:
        _, tc = _cfgs(essential_solver="8point")
        idx = sample_valid_indices(torch.Generator().manual_seed(0), _t(valid), 16, 8)
        res = tess.estimate_essential_ransac(_t(uv0), _t(uv1), _t(valid), _t(K), tc, idx)
        assert res.E.shape == (3, 3) and bool(torch.isfinite(res.E).all())
        assert bool(res.ok)
        with pytest.raises(ValueError, match=r"\(H, 8\)"):
            tess.estimate_essential_ransac(_t(uv0), _t(uv1), _t(valid), _t(K), tc,
                                           torch.zeros(4, 5, dtype=torch.long))
        with pytest.raises(ValueError, match="unknown essential_solver"):
            tess.estimate_essential_ransac(_t(uv0), _t(uv1), _t(valid), _t(K),
                                           tc.replace(essential_solver="7point"),
                                           torch.zeros(4, 8, dtype=torch.long))


def test_eight_point_system_and_solve_match_jax(scene):
    """The eight-point stages on the same rows: the constraint rows
    exactly; the per-sample solve (9 x 9 normal matrix, inverse iteration,
    closed-form SVD projection) up to sign within 1e-4 of JAX's or, on a
    sample whose null vector float32 defines worse, no farther from a
    float64 solve than twice JAX's own distance from it (two float32
    orders of one ill-defined vector); the weighted re-fit over all rows
    within 1e-4."""
    _, _, uv0, uv1, valid = scene
    x0 = ((uv0 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    x1 = ((uv1 - K[:2, 2]) / K[0, 0]).astype(np.float32)
    rows_j = np.asarray(jess._eight_point_system(jnp.asarray(x0), jnp.asarray(x1)))
    rows_t = tess._eight_point_system(_t(x0), _t(x1)).numpy()
    np.testing.assert_array_equal(rows_t, rows_j)
    idx = np.asarray(jsample(jax.random.key(5), jnp.asarray(valid), 16, 8))
    E_j = np.asarray(jess._solve_e_from_rows(jnp.asarray(rows_j[idx])))
    E_t = tess._solve_e_from_rows(_t(rows_j[idx])).numpy()
    E_64 = tess._solve_e_from_rows(_t(rows_j[idx]).double()).numpy()
    for a, b, c in zip(E_t, E_j, E_64):
        jax_err = min(np.abs(b - c).max(), np.abs(b + c).max())
        assert _same_up_to_sign(a, b, 1e-4) or _same_up_to_sign(a, c, 2.0 * jax_err)
    w = valid.astype(np.float32)
    E_wj = np.asarray(jess._solve_e_from_rows(jnp.asarray(rows_j), jnp.asarray(w)))
    E_wt = tess._solve_e_from_rows(_t(rows_j), _t(w)).numpy()
    assert _same_up_to_sign(E_wt, E_wj, 1e-4)


def test_eight_point_ransac_matches_jax(scene):
    """The eight-point RANSAC on identical (H, 8) samples: the same
    winner, so the same linear re-fit on its inliers. E up to sign within
    1e-4, the inlier sets equal up to 1% (points at the Sampson threshold),
    the count gate equal, and the recovered pose on its own E within 1e-3
    of JAX's."""
    X, T1, uv0, uv1, valid = scene
    jc, tc = _cfgs(essential_solver="8point")
    key = jax.random.key(3)
    args_j = (jnp.asarray(uv0), jnp.asarray(uv1), jnp.asarray(valid), jnp.asarray(K))
    res_j = jax.jit(lambda a, b, v, k: jess.estimate_essential_ransac(a, b, v, k, jc, key))(*args_j)
    idx = jsample(key, jnp.asarray(valid), jc.essential_hypotheses, 8)
    res_t = tess.estimate_essential_ransac(
        _t(uv0), _t(uv1), _t(valid), _t(K), tc, _t(np.asarray(idx)).long()
    )
    assert bool(res_t.ok) == bool(res_j.ok)
    assert _same_up_to_sign(res_t.E.numpy(), np.asarray(res_j.E), 1e-4)
    assert (res_t.inliers.numpy() != np.asarray(res_j.inliers)).sum() <= 0.01 * N
    R_j, t_j = jess.recover_pose(res_j.E, *args_j[:2], res_j.inliers, args_j[3])
    R_t, t_t = tess.recover_pose(res_t.E, _t(uv0), _t(uv1), res_t.inliers, _t(K))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-3)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-3)
