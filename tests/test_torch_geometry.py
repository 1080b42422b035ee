"""Port geometry (visualodometry_tpu_torch.geometry) vs the JAX reference.

Same numpy inputs from a seed through both, on the CPU. Tolerances are
float32 round-off of the same closed forms evaluated in a different
operation order (1e-5 absolute on O(1) values unless stated).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.geometry import camera as jcam
from visualodometry_tpu.geometry import linalg as jla
from visualodometry_tpu.geometry import se3 as jse3
from visualodometry_tpu.geometry import so3 as jso3
from visualodometry_tpu.geometry import triangulation as jtri
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.geometry import camera as tcam
from visualodometry_tpu_torch.geometry import linalg as tla
from visualodometry_tpu_torch.geometry import se3 as tse3
from visualodometry_tpu_torch.geometry import so3 as tso3
from visualodometry_tpu_torch.geometry import triangulation as ttri

torch.set_num_threads(2)

K = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 96.0], [0.0, 0.0, 1.0]], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(a, b, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(
        np.asarray(a.detach().numpy() if torch.is_tensor(a) else a),
        np.asarray(b), atol=atol, rtol=rtol,
    )


def _rotvecs(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:4] *= 1e-6  # small-angle series branch
    return w


def test_so3_exp_and_rotation_angle():
    rng = np.random.default_rng(0)
    w = _rotvecs(rng)
    R_j = jso3.so3_exp(jnp.asarray(w))
    R_t = tso3.so3_exp(_t(w))
    _close(R_t, R_j)
    _close(tso3.so3_hat(_t(w)), jso3.so3_hat(jnp.asarray(w)), atol=0)
    _close(
        tso3.rotation_angle(_t(np.asarray(R_j))), jso3.rotation_angle(R_j), atol=2e-5
    )


def test_se3_exp_and_inverse():
    rng = np.random.default_rng(1)
    xi = rng.normal(size=(32, 6)).astype(np.float32)
    T_j = jse3.se3_exp(jnp.asarray(xi))
    T_t = tse3.se3_exp(_t(xi))
    _close(T_t, T_j)
    _close(tse3.se3_inverse(T_t), jse3.se3_inverse(T_j))
    _close(
        tse3.make_T(T_t[:, :3, :3], T_t[:, :3, 3]),
        jse3.make_T(T_j[:, :3, :3], T_j[:, :3, 3]),
    )


def test_camera_projection_and_jacobian():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 1.0
    uv_j, z_j = jcam.project_points(jnp.asarray(pts), jnp.asarray(K))
    uv_t, z_t = tcam.project_points(_t(pts), _t(K))
    _close(uv_t, uv_j, atol=1e-3)  # pixels at focal 500
    _close(z_t, z_j)
    _close(
        tcam.projection_jacobian_point(_t(pts), _t(K)),
        jcam.projection_jacobian_point(jnp.asarray(pts), jnp.asarray(K)),
        atol=1e-3,
    )
    _close(
        tcam.pixels_to_normalized(uv_t, _t(K)),
        jcam.pixels_to_normalized(uv_j, jnp.asarray(K)),
    )


def _sym(rng, n, batch=200, rank=None):
    A = rng.normal(size=(batch, n, rank or n)).astype(np.float32)
    return (A @ np.swapaxes(A, 1, 2)).astype(np.float32)


def test_eigh3_and_svd3():
    rng = np.random.default_rng(3)
    M = _sym(rng, 3)
    w_j, V_j = jla.eigh3(jnp.asarray(M))
    w_t, V_t = tla.eigh3(_t(M))
    _close(w_t, w_j, atol=2e-4, rtol=1e-4)  # eigenvalues O(10)
    # eigenvectors up to sign
    dots = np.abs(np.sum(V_t.numpy() * np.asarray(V_j), axis=-2))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)
    E = rng.normal(size=(200, 3, 3)).astype(np.float32)
    U, s, Vt = tla.svd3(_t(E))
    U_j, s_j, Vt_j = (np.asarray(x) for x in jla.svd3(jnp.asarray(E)))
    # singular values are square roots of eigenvalues of E^T E, so compare
    # their squares: a small s carries an absolute error ~eps |E|^2 / s
    _close(s**2, s_j**2, atol=1e-4, rtol=1e-4)
    # the closed form reconstructs E no worse than the JAX one does
    err_t = np.abs(((U * s[:, None, :]) @ Vt).numpy() - E).max()
    err_j = np.abs((U_j * s_j[:, None, :]) @ Vt_j - E).max()
    assert err_t <= 2 * err_j + 1e-5, (err_t, err_j)


@pytest.mark.parametrize("n", [4, 12])
def test_smallest_eigvec_and_cholesky(n):
    """Inverse iteration (n > 3) on rank-deficient normal matrices, the
    DLT / PnP case: the null vector agrees up to sign."""
    rng = np.random.default_rng(4 + n)
    M = _sym(rng, n, rank=n - 1)
    v_j = np.asarray(jla.smallest_eigvec(jnp.asarray(M)))
    v_t = tla.smallest_eigvec(_t(M)).numpy()
    np.testing.assert_allclose(np.abs(np.sum(v_j * v_t, -1)), 1.0, atol=1e-4)
    A = _sym(rng, 6, rank=6) + 6 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(200, 6)).astype(np.float32)
    _close(
        tla.solve_psd_small(_t(A), _t(b)),
        jla.solve_psd_small(jnp.asarray(A), jnp.asarray(b)),
        atol=1e-4,
    )


def test_triangulate_points_gates():
    rng = np.random.default_rng(5)
    cfg_j = JaxConfig(min_depth=1.0, max_reproj_err=2.0, min_parallax_deg=0.35)
    cfg_t = config_from_dict(dataclasses.asdict(cfg_j))
    X = np.stack(
        [rng.uniform(-5, 5, 300), rng.uniform(-2, 2, 300), rng.uniform(4, 40, 300)], 1
    ).astype(np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.asarray(jse3.se3_exp(jnp.asarray([0.1, 0.0, -1.2, 0.0, 0.02, 0.0], jnp.float32)))
    uv1, _ = jcam.project_points_T(jnp.asarray(X), jnp.asarray(T1), jnp.asarray(K))
    uv2, _ = jcam.project_points_T(jnp.asarray(X), jnp.asarray(T2), jnp.asarray(K))
    uv1 = np.asarray(uv1) + rng.normal(0, 0.3, (300, 2)).astype(np.float32)
    uv2 = np.asarray(uv2) + rng.normal(0, 0.3, (300, 2)).astype(np.float32)
    valid_in = rng.random(300) > 0.1
    p_j, v_j = jtri.triangulate_points(
        jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.asarray(K), cfg_j, valid_in=jnp.asarray(valid_in),
    )
    p_t, v_t = ttri.triangulate_points(
        _t(T1), _t(T2), _t(uv1), _t(uv2), _t(K), cfg_t, valid_in=_t(valid_in)
    )
    v_j = np.asarray(v_j)
    # gates agree except where a point sits on a threshold
    assert (v_j != v_t.numpy()).sum() <= 2
    both = v_j & v_t.numpy()
    # depth is conditioned to unit baseline; relative agreement 1e-3
    np.testing.assert_allclose(
        p_t.numpy()[both], np.asarray(p_j)[both], rtol=1e-3, atol=1e-3
    )
