"""Small-matrix linear algebra as closed-form / unrolled tensor arithmetic.

Port of the parts of visualodometry_tpu/geometry/linalg.py that the
SIFT -> kNN -> RANSAC path calls: `eigh3` (Cardano), `svd3`,
`smallest_eigvec` (shifted inverse iteration through an unrolled
Cholesky), `cholesky_small` / `cho_solve_small` and `solve_psd_small`.
The closed forms are kept as written because they set the numerics of the
essential / PnP estimators; `torch.linalg` would give different (LAPACK or
cuSOLVER) numerics. Everything is batched over leading dims.
"""

from __future__ import annotations

import math

import torch

_TINY = 1e-20


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def eigh3(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form eigendecomposition of symmetric (..., 3, 3).

    Returns (w, V): eigenvalues ascending (..., 3), orthonormal
    eigenvectors in the columns of V (..., 3, 3).
    """
    a00 = M[..., 0, 0]
    a01 = M[..., 0, 1]
    a02 = M[..., 0, 2]
    a11 = M[..., 1, 1]
    a12 = M[..., 1, 2]
    a22 = M[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_TINY))

    inv_p = 1.0 / p
    c00 = b00 * inv_p
    c01 = a01 * inv_p
    c02 = a02 * inv_p
    c11 = b11 * inv_p
    c12 = a12 * inv_p
    c22 = b22 * inv_p
    detB = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    two_p = 2.0 * p
    w2 = q + two_p * torch.cos(phi)  # largest
    w0 = q + two_p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2

    def eigvec(lam: torch.Tensor) -> torch.Tensor:
        """Eigenvector of M for eigenvalue lam via largest row cross."""
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c0 = _cross(r0, r1)
        c1 = _cross(r0, r2)
        c2 = _cross(r1, r2)
        n0 = torch.sum(c0 * c0, dim=-1)
        n1 = torch.sum(c1 * c1, dim=-1)
        n2 = torch.sum(c2 * c2, dim=-1)
        best12 = torch.where((n1 >= n2)[..., None], c1, c2)
        nbest12 = torch.maximum(n1, n2)
        v = torch.where((n0 >= nbest12)[..., None], c0, best12)
        nv = torch.maximum(n0, nbest12)
        fallback = torch.zeros_like(v)
        fallback[..., 0].fill_(1.0)
        v = torch.where((nv > _TINY)[..., None], v, fallback)
        return v / _norm(v)

    gap_low = w1 - w0
    gap_high = w2 - w1
    iso_is_low = gap_low >= gap_high
    lam_iso = torch.where(iso_is_low, w0, w2)
    lam_other = torch.where(iso_is_low, w2, w0)

    v_iso = eigvec(lam_iso)
    v_oth = eigvec(lam_other)
    v_oth = v_oth - torch.sum(v_iso * v_oth, dim=-1, keepdim=True) * v_iso
    n_oth = _norm(v_oth)
    alt = _any_orthonormal(v_iso)
    v_oth = torch.where(n_oth > 1e-12, v_oth / torch.clamp(n_oth, min=_TINY), alt)
    v_mid = _cross(v_iso, v_oth)

    v0 = torch.where(iso_is_low[..., None], v_iso, v_oth)
    v2 = torch.where(iso_is_low[..., None], v_oth, v_iso)

    w = torch.stack([w0, w1, w2], dim=-1)
    V = torch.stack([v0, v_mid, v2], dim=-1)  # columns
    return w, V


def _any_orthonormal(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit v (..., 3), branchless."""
    ax = torch.abs(v[..., 0])
    az = torch.abs(v[..., 2])
    ex = torch.zeros_like(v)
    ex[..., 0].fill_(1.0)
    ez = torch.zeros_like(v)
    ez[..., 2].fill_(1.0)
    e = torch.where((ax <= az)[..., None], ex, ez)
    u = _cross(v, e)
    return u / torch.clamp(_norm(u), min=_TINY)


def cholesky_small(M: torch.Tensor):
    """Unrolled batched Cholesky of symmetric PD (..., n, n), static n.

    Returns the lower factor as a list of lists of (...,) tensors
    (L[i][j] for j <= i). Pivots are clamped to stay finite on
    semidefinite input.
    """
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=_TINY))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def cho_solve_small(L, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b with L from `cholesky_small`; b: (..., n)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def smallest_eigvec(M: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n).

    n=3 uses the closed form; larger n uses shifted inverse iteration
    through one unrolled Cholesky factorization.
    """
    n = M.shape[-1]
    if n == 3:
        _, V = eigh3(M)
        return V[..., :, 0]

    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    eps = (torch.abs(tr) / n) * 1e-6 + 1e-12
    Ms = M + eps[..., None, None] * torch.eye(n, dtype=M.dtype, device=M.device)
    L = cholesky_small(Ms)

    v = (1.0 + 0.01 * torch.arange(n, dtype=M.dtype, device=M.device)).expand(
        M.shape[:-1]
    )
    for _ in range(iters):
        v = cho_solve_small(L, v)
        v = v / torch.clamp(_norm(v), min=_TINY)
    return v


def svd3(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form SVD of (..., 3, 3) via eigh3 of E^T E.

    Returns (U, s, Vt) with s descending; the third left singular vector
    is the cross product of the first two, so U stays orthogonal when
    s[2] ~ 0 (essential matrices).
    """
    EtE = E.transpose(-1, -2) @ E
    w, V = eigh3(EtE)  # ascending
    w = torch.flip(w, dims=[-1])
    V = torch.flip(V, dims=[-1])
    s = torch.sqrt(torch.clamp(w, min=0.0))
    EV = E @ V
    u0 = EV[..., :, 0] / torch.clamp(s[..., 0:1], min=1e-12)
    u0 = u0 / torch.clamp(_norm(u0), min=1e-12)
    u1 = EV[..., :, 1] / torch.clamp(s[..., 1:2], min=1e-12)
    u1 = u1 - torch.sum(u0 * u1, dim=-1, keepdim=True) * u0
    n1 = _norm(u1)
    u1 = torch.where(
        n1 > 1e-12, u1 / torch.clamp(n1, min=_TINY), _any_orthonormal(u0)
    )
    u2 = _cross(u0, u1)
    d = torch.sum(u2 * EV[..., :, 2], dim=-1, keepdim=True)
    u2 = torch.where(d < 0.0, -u2, u2)
    U = torch.stack([u0, u1, u2], dim=-1)
    Vt = V.transpose(-1, -2)
    return U, s, Vt


def solve_psd_small(
    A: torch.Tensor, b: torch.Tensor, damping: float = 0.0
) -> torch.Tensor:
    """Solve (A + damping*I) x = b for small symmetric PD A via unrolled
    Cholesky; A: (..., n, n), b: (..., n)."""
    n = A.shape[-1]
    if damping:
        A = A + damping * torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_small(A)
    return cho_solve_small(L, b)
