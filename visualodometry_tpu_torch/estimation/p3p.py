"""Batched P3P minimal solver (Grunert).

Port of visualodometry_tpu/estimation/p3p.py. With unit bearings f1, f2,
f3 and world points X1, X2, X3, set u = d2/d1, v = d3/d1. The two
law-of-cosines ratios give two monic quadratics in u whose coefficients
are quadratic in v:

  Q1(u) = u^2 - 2 cos(gamma) u + (1 - B w(v))      B = |X1-X2|'^2
  Q2(u) = u^2 - 2 v cos(alpha) u + (v^2 - A w(v))  A = |X2-X3|'^2
  w(v)  = 1 + v^2 - 2 v cos(beta)        (primes: normalized by |X1-X3|^2)

Their resultant R(v) is a quartic whose coefficients are recovered by
evaluating R at five fixed abscissae and applying one constant inverse
Vandermonde matrix. Its roots come from a fixed 40 iterations of
Durand-Kerner in complex64; each real positive root yields distances and
a rigid pose by triad composition. Up to 4 poses per sample: the RANSAC
layer scores them all.

`p3p_grunert` runs the plain version, `_p3p_grunert_torch`, on CPU
tensors, and one launch of csrc/p3p.cu (ops/p3p.py) on CUDA tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from visualodometry_tpu_torch.ops import p3p as p3p_ops

# abscissae for exact quartic coefficient recovery (constant, host-side)
_VS = (-2.0, -1.0, 0.0, 1.0, 2.0)
_VANDER_INV = np.linalg.inv(np.vander(np.array(_VS), 5, increasing=True)).astype(
    np.float32
)  # coeffs c0..c4 from R(v) samples
_DK_SEED = np.array([(0.4 + 0.9j) ** k for k in range(1, 5)], np.complex64)


@lru_cache(maxsize=None)
def _constants(device: torch.device):
    """(abscissae (5,), inverse Vandermonde transposed (5, 5), Durand-Kerner
    seeds (4,)) on `device`: copied once, since a host-to-device copy per
    call makes the host wait for the device."""
    return (
        torch.tensor(_VS, dtype=torch.float32).to(device),
        torch.as_tensor(_VANDER_INV.T.copy()).to(device),
        torch.as_tensor(_DK_SEED).to(device),
    )


def _resultant_monic_quadratics(b1, c1, b2, c2):
    """Resultant of u^2 + b1 u + c1 and u^2 + b2 u + c2 (elementwise)."""
    return (c1 - c2) ** 2 - (b2 - b1) * (b1 * c2 - b2 * c1)


def _durand_kerner4(coeffs: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """Roots of a batched quartic c0 + c1 v + ... + c4 v^4.

    coeffs: (..., 5) complex64. Returns (..., 4) complex roots. The roots
    are updated one after the other within an iteration (Gauss-Seidel
    order), as in the JAX function.
    """
    c4 = coeffs[..., 4:5]
    scale = torch.where(c4.abs() > 1e-12, c4, 1e-12)
    mon = coeffs / scale  # monic
    seed = _constants(coeffs.device)[2]
    z = list(seed.expand(coeffs.shape[:-1] + (4,)).unbind(-1))

    def poly(zi):
        r = torch.zeros_like(zi)
        for k in range(4, -1, -1):
            r = r * zi + mon[..., k]
        return r

    for _ in range(iters):
        for i in range(4):
            denom = torch.ones_like(z[i])
            for j in range(4):
                if j != i:
                    denom = denom * (z[i] - z[j])
            denom = torch.where(denom.abs() > 1e-12, denom, 1e-12)
            z[i] = z[i] - poly(z[i]) / denom
    return torch.stack(z, dim=-1)


def _triad(P: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame from 3 points (rows of P, shape (..., 3, 3)).

    Columns of the result are the Gram-Schmidt frame of the edge vectors
    P2-P1, P3-P1. Collinear triples give non-finite entries, masked by the
    caller's isfinite check.
    """
    e1 = P[..., 1, :] - P[..., 0, :]
    e2 = P[..., 2, :] - P[..., 0, :]
    a1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=1e-12)
    r2 = e2 - torch.sum(e2 * a1, -1, keepdim=True) * a1
    n2 = torch.linalg.vector_norm(r2, dim=-1, keepdim=True)
    a2 = r2 / torch.where(n2 > 1e-9, n2, torch.nan)
    a3 = torch.linalg.cross(a1, a2, dim=-1)
    return torch.stack([a1, a2, a3], dim=-1)  # columns


def _kabsch3(Pc: torch.Tensor, Xw: torch.Tensor):
    """Rigid T_cw from 3 camera-frame points and 3 world points.

    Pc, Xw: (..., 3, 3), rows = points. Returns R (..., 3, 3), t (..., 3)
    with Pc ~= R Xw + t. P3P's triples are congruent per hypothesis, so
    the alignment is the triad composition R = F_c F_w^T: exact on
    congruent triples and well-conditioned on elongated ones, where an SVD
    of the cross-covariance is not.
    """
    Fc = _triad(Pc)
    Fw = _triad(Xw)
    R = Fc @ Fw.transpose(-1, -2)
    t = Pc[..., 0, :] - torch.einsum("...ij,...j->...i", R, Xw[..., 0, :])
    return R, t


def p3p_grunert(X: torch.Tensor, xy: torch.Tensor):
    """Batched P3P: world points + normalized image points -> 4 poses.

    X: (H, 3, 3) world points (rows); xy: (H, 3, 2) normalized image
    coordinates, both contiguous float32. Returns (R (H, 4, 3, 3),
    t (H, 4, 3), ok (H, 4)): up to four camera-from-world poses per
    sample, masked by `ok`. CPU tensors take the plain version; CUDA
    tensors are one launch of csrc/p3p.cu on the current stream, with no
    host read.
    """
    p3p_ops.check(X, xy)
    if X.device.type == "cpu":
        return _p3p_grunert_torch(X, xy)
    return p3p_ops.p3p_cuda(X, xy, *_constants(X.device))


def _p3p_grunert_torch(X: torch.Tensor, xy: torch.Tensor):
    """Plain version of `p3p_grunert`, one batched tensor operation per
    scalar step: the CPU route and the kernel's contract."""
    f = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)  # (H, 3, 3)
    X1, X2, X3 = X[:, 0], X[:, 1], X[:, 2]
    f1, f2, f3 = f[:, 0], f[:, 1], f[:, 2]

    b2 = torch.sum((X1 - X3) ** 2, -1)  # |X1-X3|^2  (normalizer)
    a2 = torch.sum((X2 - X3) ** 2, -1)
    c2 = torch.sum((X1 - X2) ** 2, -1)
    nz = torch.clamp(b2, min=1e-12)
    A = (a2 / nz)[:, None]
    B = (c2 / nz)[:, None]
    ca = torch.sum(f2 * f3, -1)[:, None]  # cos(alpha)
    cb = torch.sum(f1 * f3, -1)[:, None]  # cos(beta)
    cg = torch.sum(f1 * f2, -1)[:, None]  # cos(gamma)

    def quadratics(v):
        """(b1, c1, b2, c2) of Q1, Q2 at v (H, n)."""
        w = 1.0 + v * v - 2.0 * v * cb
        return -2.0 * cg, 1.0 - B * w, -2.0 * v * ca, v * v - A * w

    def res_at(v):
        return _resultant_monic_quadratics(*quadratics(v))

    # sample the resultant at the fixed abscissae, recover c0..c4
    vs, vander_inv_t, _ = _constants(X.device)
    S = res_at(vs[None, :].expand(X.shape[0], 5))  # (H, 5)
    coeffs = S @ vander_inv_t  # (H, 5)

    roots = _durand_kerner4(coeffs.to(torch.complex64))  # (H, 4)
    v = roots.real

    # Newton polish against the resultant evaluated directly (no
    # Vandermonde round trip): recovers the float32 accuracy that the
    # coefficient recovery loses on elongated triples
    h = 1e-4 * (1.0 + v.abs())
    for _ in range(3):
        r0 = res_at(v)
        dr = (res_at(v + h) - res_at(v - h)) / (2.0 * h)
        stepv = r0 / torch.where(dr.abs() > 1e-12, dr, 1e-12)
        v = v - torch.clamp(stepv, -0.1, 0.1)
    real = roots.imag.abs() < 1e-3 * (1.0 + v.abs())
    pos = v > 1e-6

    w = 1.0 + v * v - 2.0 * v * cb  # (H, 4)
    # common root of the two quadratics: u = (c1 - c2) / (b2 - b1)
    b1_, c1_, b2_, c2_ = quadratics(v)
    den = b2_ - b1_
    u = (c1_ - c2_) / torch.where(den.abs() > 1e-9, den, 1e-9)

    d1 = torch.sqrt(nz[:, None] / torch.clamp(w, min=1e-12))
    ok = real & pos & (u > 1e-6) & (w > 1e-9)
    d2 = u * d1
    d3 = v * d1

    Pc = torch.stack(
        [
            d1[..., None] * f1[:, None, :],
            d2[..., None] * f2[:, None, :],
            d3[..., None] * f3[:, None, :],
        ],
        dim=-2,
    )  # (H, 4, 3pts, 3)
    Xw = X[:, None].expand(Pc.shape)
    R, t = _kabsch3(Pc, Xw)
    ok = ok & torch.isfinite(R).all(-1).all(-1) & torch.isfinite(t).all(-1)
    return R, t, ok
