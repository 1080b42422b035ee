"""Batched Nistér five-point minimal solver for the essential matrix.

Port of visualodometry_tpu/estimation/fivepoint.py, step for step: null
basis by subspace inverse iteration (here in float64, see `null_basis`),
the 10 cubic constraints expanded by
a small polynomial-algebra helper, Gauss-Jordan with partial pivoting, the
degree-10 determinant polynomial, fixed-iteration Durand-Kerner root
finding (a Python loop over batched tensors), back-substitution, a damped
GN polish and projection onto the essential manifold.
"""

from __future__ import annotations

import math

import torch

from vobench.reference.geometry.linalg import (
    _cross,
    cho_solve_small,
    cholesky_small,
    solve_psd_small,
    svd3,
)

_TINY = 1e-20

# Nistér's 20-monomial cubic basis x^i y^j z^k, split as 10 leading
# (eliminated) + 10 tail columns [xz², xz, x, yz², yz, y, z³, z², z, 1].
_MONOMIALS: tuple[tuple[int, int, int], ...] = (
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
)
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}


class _Poly3:
    """Trivariate polynomial with batched tensor coefficients, keyed by
    (i, j, k) exponents of x^i y^j z^k."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict):
        self.terms = terms

    @staticmethod
    def linear(cx, cy, cz, c1) -> "_Poly3":
        return _Poly3({(1, 0, 0): cx, (0, 1, 0): cy, (0, 0, 1): cz, (0, 0, 0): c1})

    def __add__(self, other: "_Poly3") -> "_Poly3":
        t = dict(self.terms)
        for e, c in other.terms.items():
            t[e] = t[e] + c if e in t else c
        return _Poly3(t)

    def __sub__(self, other: "_Poly3") -> "_Poly3":
        t = dict(self.terms)
        for e, c in other.terms.items():
            t[e] = t[e] - c if e in t else -c
        return _Poly3(t)

    def __mul__(self, other: "_Poly3") -> "_Poly3":
        t: dict = {}
        for ea, ca in self.terms.items():
            for eb, cb in other.terms.items():
                e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
                prod = ca * cb
                t[e] = t[e] + prod if e in t else prod
        return _Poly3(t)

    def scale(self, s) -> "_Poly3":
        return _Poly3({e: c * s for e, c in self.terms.items()})

    def coeff_row(self, like: torch.Tensor) -> torch.Tensor:
        """Coefficients over the 20-monomial basis: (..., 20)."""
        zeros = torch.zeros_like(like)
        cols = [zeros] * 20
        for e, c in self.terms.items():
            cols[_MONO_INDEX[e]] = cols[_MONO_INDEX[e]] + c
        return torch.stack(cols, dim=-1)


def rank2_diag(like: torch.Tensor) -> torch.Tensor:
    """The essential-manifold singular values (1, 1, 0), on like's device
    (built there: a host constant would be copied with a synchronisation)."""
    return 1.0 - torch.eye(3, dtype=like.dtype, device=like.device)[2]


def null_basis(M: torch.Tensor, k: int, iters: int = 8) -> torch.Tensor:
    """Orthonormal basis (..., n, k) of the k-dim smallest-eigenvalue
    subspace of symmetric PSD (..., n, n), via subspace inverse iteration.

    The iteration runs in float64 and the basis is returned in M's dtype.
    In float32 the shifted system (condition ~1e6 by construction) leaves
    the basis good to ~1e-3 only: different operation orders gave bases
    whose projectors differ by that much. `torch.linalg.eigh` would do as
    well, but on CUDA it reads its status back on the host; this loop
    never waits for the device.

    The shift is set by M's precision. A float32 M keeps the JAX
    function's 1e-6 of the mean diagonal: its rounding leaves eigenvalues
    down to -1e-8 of the trace, which a smaller shift would not cover. A
    float64 M (`five_point_candidates` forms it so) takes 1e-10, so a
    near-degenerate sample whose fifth eigenvalue is ~1e-7 of the trace
    still converges in `iters` steps.
    """
    rel = 1e-6 if M.dtype == torch.float32 else 1e-10
    dtype = M.dtype
    M = M.to(torch.float64)
    n = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eps = (torch.abs(tr) / n) * rel + 1e-30
    Ms = M + eps[..., None, None] * torch.eye(n, dtype=M.dtype, device=M.device)
    L = cholesky_small(Ms)

    i = torch.arange(n, dtype=M.dtype, device=M.device)[:, None]
    j = torch.arange(k, dtype=M.dtype, device=M.device)[None, :]
    V0 = torch.cos((i + 1.0) * (j + 1.0)) + 0.1
    V = V0.expand(M.shape[:-2] + (n, k))

    def orthonormalize(V):
        out = []
        for c in range(k):
            v = V[..., :, c]
            for u in out:
                v = v - torch.sum(u * v, dim=-1, keepdim=True) * u
            nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            fallback = torch.zeros_like(v)
            fallback[..., c].fill_(1.0)
            v = torch.where(nv > 1e-12, v / torch.clamp(nv, min=_TINY), fallback)
            out.append(v)
        return torch.stack(out, dim=-1)

    for _ in range(iters):
        cols = [cho_solve_small(L, V[..., :, c]) for c in range(k)]
        V = orthonormalize(torch.stack(cols, dim=-1))
    return V.to(dtype)


def _constraint_rows(Ebasis: torch.Tensor) -> torch.Tensor:
    """The (..., 10, 20) cubic-constraint coefficient matrix from the
    (..., 9, 4) null basis (E = x E1 + y E2 + z E3 + E4)."""
    like = Ebasis[..., 0, 0]
    Ep = [
        _Poly3.linear(
            Ebasis[..., r * 3 + c, 0],
            Ebasis[..., r * 3 + c, 1],
            Ebasis[..., r * 3 + c, 2],
            Ebasis[..., r * 3 + c, 3],
        )
        for r in range(3)
        for c in range(3)
    ]

    def E(r, c):
        return Ep[r * 3 + c]

    det = (
        E(0, 0) * (E(1, 1) * E(2, 2) - E(1, 2) * E(2, 1))
        - E(0, 1) * (E(1, 0) * E(2, 2) - E(1, 2) * E(2, 0))
        + E(0, 2) * (E(1, 0) * E(2, 1) - E(1, 1) * E(2, 0))
    )
    G = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for c in range(r, 3):
            s = E(r, 0) * E(c, 0) + E(r, 1) * E(c, 1) + E(r, 2) * E(c, 2)
            G[r][c] = s
            G[c][r] = s
    trG = G[0][0] + G[1][1] + G[2][2]

    rows = [det.coeff_row(like)]
    for r in range(3):
        for c in range(3):
            GE = G[r][0] * E(0, c) + G[r][1] * E(1, c) + G[r][2] * E(2, c)
            poly = GE.scale(2.0) - trG * E(r, c)
            rows.append(poly.coeff_row(like))
    return torch.stack(rows, dim=-2)


def _gauss_jordan_tail(A: torch.Tensor) -> torch.Tensor:
    """Reduce (..., 10, 20) to [I | B] with partial pivoting; return B."""
    n = A.shape[-2]
    rmax = torch.amax(torch.abs(A), dim=-1, keepdim=True)
    A = A / torch.clamp(rmax, min=_TINY)
    ar = torch.arange(n, device=A.device)
    for col in range(n):
        colvals = torch.abs(A[..., :, col])
        colvals = torch.where(ar >= col, colvals, -1.0)
        piv = torch.argmax(colvals, dim=-1)
        pivb = piv[..., None]
        perm = torch.where(ar == col, pivb, ar.expand(pivb.shape[:-1] + (n,)))
        perm = torch.where(ar == pivb, col, perm)
        A = torch.gather(A, -2, perm[..., :, None].expand(A.shape))
        pivot = A[..., col, col]
        safe = torch.abs(pivot) > _TINY
        inv_p = torch.where(safe, 1.0 / torch.where(safe, pivot, 1.0), 0.0)
        row = A[..., col, :] * inv_p[..., None]
        A = A.clone()
        A[..., col, :] = row
        factors = A[..., :, col].clone()
        factors[..., col].fill_(0.0)
        A = A - factors[..., :, None] * row[..., None, :]
    return A[..., :, n:]


def _polymul(a: list, b: list) -> list:
    out = [None] * (len(a) + len(b) - 1)
    for i, ca in enumerate(a):
        for j, cb in enumerate(b):
            p = ca * cb
            out[i + j] = p if out[i + j] is None else out[i + j] + p
    return out


def _polysub(a: list, b: list) -> list:
    n = max(len(a), len(b))
    out = []
    for i in range(n):
        ca = a[i] if i < len(a) else None
        cb = b[i] if i < len(b) else None
        if ca is None:
            out.append(-cb)
        elif cb is None:
            out.append(ca)
        else:
            out.append(ca - cb)
    return out


def _action_polys(B: torch.Tensor):
    """The 3x3 polynomial matrix B(z) from the reduced tail (..., 10, 10)."""

    def combined(e: int, f: int):
        Be = B[..., e, :]
        Bf = B[..., f, :]
        z0 = torch.zeros_like(Be[..., 0])
        px = _polysub([Be[..., 2], Be[..., 1], Be[..., 0]],
                      [z0, Bf[..., 2], Bf[..., 1], Bf[..., 0]])
        py = _polysub([Be[..., 5], Be[..., 4], Be[..., 3]],
                      [z0, Bf[..., 5], Bf[..., 4], Bf[..., 3]])
        p1 = _polysub([Be[..., 9], Be[..., 8], Be[..., 7], Be[..., 6]],
                      [z0, Bf[..., 9], Bf[..., 8], Bf[..., 7], Bf[..., 6]])
        return px, py, p1

    return combined(4, 5), combined(6, 7), combined(8, 9)


def _det_poly(rows) -> torch.Tensor:
    """det of the 3x3 polynomial matrix -> degree-10 poly, (..., 11) ascending."""
    (pxk, pyk, p1k), (pxl, pyl, p1l), (pxm, pym, p1m) = rows
    t0 = _polysub(_polymul(pyl, p1m), _polymul(pym, p1l))
    t1 = _polysub(_polymul(pxl, p1m), _polymul(pxm, p1l))
    t2 = _polysub(_polymul(pxl, pym), _polymul(pxm, pyl))
    det = _polysub(_polymul(pxk, t0), _polymul(pyk, t1))
    t2k = _polymul(p1k, t2)
    n = max(len(det), len(t2k))
    out = []
    for i in range(n):
        a = det[i] if i < len(det) else None
        b = t2k[i] if i < len(t2k) else None
        out.append(b if a is None else (a if b is None else a + b))
    while len(out) < 11:
        out.append(torch.zeros_like(out[0]))
    return torch.stack(out[:11], dim=-1)


def _durand_kerner(coeffs: torch.Tensor, iters: int = 60):
    """All 10 roots of (..., 11) ascending-coefficient polynomials.

    Fixed-iteration Durand-Kerner with complex arithmetic as (re, im)
    float pairs. Returns (re, im): (..., 10).
    """
    scale = torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
    c = coeffs / torch.clamp(scale, min=_TINY)
    lead = c[..., 10]
    lead_safe = torch.where(
        torch.abs(lead) > 1e-4,
        lead,
        torch.where(lead >= 0, 1e-4, -1e-4),
    )
    c = c / lead_safe[..., None]

    r0 = torch.clamp(1.0 + torch.amax(torch.abs(c[..., :10]), dim=-1), max=16.0)
    k = torch.arange(10, dtype=coeffs.dtype, device=coeffs.device)
    theta = 2.0 * math.pi * k / 10.0 + 0.37
    zre = r0[..., None] * torch.cos(theta)
    zim = r0[..., None] * torch.sin(theta)
    eye = torch.eye(10, dtype=coeffs.dtype, device=coeffs.device)
    lim = 2.0 * (1.0 + r0[..., None])

    for _ in range(iters):
        pre = torch.ones_like(zre)
        pim = torch.zeros_like(zim)
        for i in range(9, -1, -1):
            pre, pim = (
                pre * zre - pim * zim + c[..., i][..., None],
                pre * zim + pim * zre,
            )
        dre = zre[..., :, None] - zre[..., None, :]
        dim = zim[..., :, None] - zim[..., None, :]
        dre = dre * (1.0 - eye) + eye
        dim = dim * (1.0 - eye)
        qre = torch.ones_like(zre)
        qim = torch.zeros_like(zim)
        for j in range(10):
            qre, qim = (
                qre * dre[..., :, j] - qim * dim[..., :, j],
                qre * dim[..., :, j] + qim * dre[..., :, j],
            )
        q2 = torch.clamp(qre * qre + qim * qim, min=_TINY)
        wre = (pre * qre + pim * qim) / q2
        wim = (pim * qre - pre * qim) / q2
        wmag = torch.sqrt(wre * wre + wim * wim)
        f = torch.where(wmag > lim, lim / torch.clamp(wmag, min=_TINY), 1.0)
        zre = zre - f * wre
        zim = zim - f * wim
        zmag = torch.sqrt(zre * zre + zim * zim)
        g = torch.where(zmag > 32.0, 32.0 / torch.clamp(zmag, min=_TINY), 1.0)
        zre, zim = zre * g, zim * g
    bad = ~(torch.isfinite(zre) & torch.isfinite(zim))
    zre = torch.where(bad, 0.0, zre)
    zim = torch.where(bad, 1e6, zim)
    return zre, zim


def _polyval_list(p: list, z: torch.Tensor) -> torch.Tensor:
    """Evaluate an ascending-coefficient poly (list of (...,) tensors) at
    z: (..., R) -> (..., R)."""
    out = p[-1][..., None].expand(p[-1].shape + z.shape[-1:])
    for c in reversed(p[:-1]):
        out = out * z + c[..., None]
    return out


def _mono20_and_jac(x, y, z):
    """The 20-monomial vector m(x,y,z) (..., 20) and its Jacobian (..., 20, 3)."""
    ones = torch.ones_like(x)
    zeros = torch.zeros_like(x)

    def powv(v, k):
        if k <= 0:
            return ones
        p = v
        for _ in range(k - 1):
            p = p * v
        return p

    m, J = [], []
    for (i, j, k) in _MONOMIALS:
        xi, yj, zk = powv(x, i), powv(y, j), powv(z, k)
        m.append(xi * yj * zk)
        dx = i * powv(x, i - 1) * yj * zk if i > 0 else zeros
        dy = j * xi * powv(y, j - 1) * zk if j > 0 else zeros
        dz = k * xi * yj * powv(z, k - 1) if k > 0 else zeros
        J.append(torch.stack([dx, dy, dz], dim=-1))
    return torch.stack(m, dim=-1), torch.stack(J, dim=-2)


def _polish_xyz(A, x, y, z, iters: int = 3):
    """Damped GN refinement of candidate (x, y, z) on the exact constraint
    system A (..., 10, 20); x, y, z: (..., R)."""
    for _ in range(iters):
        m, Jm = _mono20_and_jac(x, y, z)
        r = torch.einsum("...cm,...rm->...rc", A, m)
        J = torch.einsum("...cm,...rmv->...rcv", A, Jm)
        JtJ = torch.einsum("...rcv,...rcw->...rvw", J, J)
        Jtr = torch.einsum("...rcv,...rc->...rv", J, r)
        lam = 1e-6 * torch.diagonal(JtJ, dim1=-2, dim2=-1).sum(-1)[..., None, None] / 3.0
        JtJ = JtJ + (lam + 1e-12) * torch.eye(3, dtype=JtJ.dtype, device=JtJ.device)
        delta = solve_psd_small(JtJ, Jtr)
        x = x - delta[..., 0]
        y = y - delta[..., 1]
        z = z - delta[..., 2]
    return x, y, z


def five_point_candidates(
    x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Essential-matrix candidates for batched minimal samples.

    x0, x1: (H, 5, 2) normalized coordinates. Returns (E (H, 10, 3, 3) on
    the essential manifold, valid (H, 10)).
    """
    a, b = x0[..., 0], x0[..., 1]
    c, d = x1[..., 0], x1[..., 1]
    one = torch.ones_like(a)
    rows = torch.stack([c * a, c * b, c, d * a, d * b, d, a, b, one], dim=-1)

    # the normal matrix is formed in float64 too (see null_basis)
    rows = rows.to(torch.float64)
    AtA = torch.einsum("...ni,...nj->...ij", rows, rows)
    Ebasis = null_basis(AtA, 4).to(x0.dtype)  # (H, 9, 4)

    A = _constraint_rows(Ebasis)  # (H, 10, 20)
    B = _gauss_jordan_tail(A)  # (H, 10, 10)
    prows = _action_polys(B)
    det10 = _det_poly(prows)  # (H, 11)
    zre, zim = _durand_kerner(det10)  # (H, 10) each

    real_ok = torch.abs(zim) <= 0.02 * (1.0 + torch.abs(zre))

    (pxk, pyk, p1k), (pxl, pyl, p1l), (pxm, pym, p1m) = prows
    z = zre
    Brows = [
        torch.stack(
            [_polyval_list(px, z), _polyval_list(py, z), _polyval_list(p1, z)],
            dim=-1,
        )
        for px, py, p1 in ((pxk, pyk, p1k), (pxl, pyl, p1l), (pxm, pym, p1m))
    ]
    c01 = _cross(Brows[0], Brows[1])
    c02 = _cross(Brows[0], Brows[2])
    c12 = _cross(Brows[1], Brows[2])
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    v = torch.where((n02 >= n12)[..., None], c02, c12)
    nv = torch.maximum(n02, n12)
    v = torch.where((n01 >= nv)[..., None], c01, v)
    nv = torch.maximum(n01, nv)
    vnorm = torch.sqrt(torch.clamp(nv, min=_TINY))
    w = v[..., 2]
    w_ok = torch.abs(w) > 1e-6 * vnorm
    w_safe = torch.where(w_ok, w, 1.0)
    x = v[..., 0] / w_safe
    y = v[..., 1] / w_safe

    x, y, z = _polish_xyz(A, x, y, z)

    Eb = Ebasis.reshape(Ebasis.shape[:-2] + (3, 3, 4))  # (H, 3, 3, 4)
    E = (
        x[..., None, None] * Eb[..., None, :, :, 0]
        + y[..., None, None] * Eb[..., None, :, :, 1]
        + z[..., None, None] * Eb[..., None, :, :, 2]
        + Eb[..., None, :, :, 3]
    )  # (H, 10, 3, 3)

    U, _, Vt = svd3(E)
    E = (U * rank2_diag(E)) @ Vt
    return E, real_ok & w_ok
