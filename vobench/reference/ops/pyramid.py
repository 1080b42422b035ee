"""Gaussian scale-space and Difference-of-Gaussians pyramids, plain.

Frozen copy of the band-matmul route of visualodometry_tpu_torch/ops/
pyramid.py: a 1D edge-padded convolution along an axis of length n is a
matmul with an (n, n) band matrix, so one octave's Gaussian stack is two
batched matrix products, in full float32 (TF32 off). The band matrices are
built here with numpy, per shape, and cached per device. The blur-stack
kernel route is not copied.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from vobench.reference.precision import mm



def _full_kernel_np(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def gaussian_kernel_1d(sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Odd-length 1D Gaussian, radius ceil(3 sigma) (<0.3% truncated mass)."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    return torch.as_tensor(_full_kernel_np(sigma, radius), dtype=dtype, device=device)


def _band_matrix_np(n: int, kern: np.ndarray) -> np.ndarray:
    """(n, n) matrix B with (row_in @ B) == edge-padded 1D conv of row_in."""
    r = (len(kern) - 1) // 2
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(-r, r + 1):
            j = min(max(i + t, 0), n - 1)
            B[j, i] += kern[t + r]
    return B


@lru_cache(maxsize=None)
def _blur_mats(h: int, w: int, sigma: float):
    k = _full_kernel_np(sigma, max(1, int(math.ceil(3.0 * sigma))))
    return _band_matrix_np(h, k), _band_matrix_np(w, k)


@lru_cache(maxsize=None)
def _octave_mats(h: int, w: int, scales: int, sigma0: float):
    """Per-level band matrices for one octave: (C, H, H) and (C, W, W).

    Level i of the stack has absolute blur sigma0 * 2^((i+1)/scales),
    produced directly from the octave base in one hop.
    """
    k = 2.0 ** (1.0 / scales)
    n_out = scales + 2
    sigmas = [
        math.sqrt(max((sigma0 * k ** (i + 1)) ** 2 - sigma0**2, 1e-8))
        for i in range(n_out)
    ]
    radius = max(1, int(math.ceil(3.0 * max(sigmas))))
    Bv = np.stack([_band_matrix_np(h, _full_kernel_np(s, radius)) for s in sigmas])
    Bh = np.stack([_band_matrix_np(w, _full_kernel_np(s, radius)) for s in sigmas])
    return Bv, Bh


@lru_cache(maxsize=None)
def _blur_mats_on(h: int, w: int, sigma: float, device: torch.device):
    return tuple(torch.as_tensor(m).to(device) for m in _blur_mats(h, w, sigma))


@lru_cache(maxsize=None)
def _octave_mats_on(h: int, w: int, scales: int, sigma0: float, device: torch.device):
    return tuple(
        torch.as_tensor(m).to(device) for m in _octave_mats(h, w, scales, sigma0)
    )


def blur_2d(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) with edge ("SAME") handling."""
    H, W = img.shape[-2:]
    sigma = float(sigma)
    Bv, Bh = _blur_mats_on(H, W, sigma, img.device)
    # out = Bv^T @ img @ Bh  (B maps input index -> output index)
    return mm(Bv.T, mm(img.to(torch.float32), Bh))


def build_gaussian_octave(
    base: torch.Tensor, sigma0: float, scales: int
) -> torch.Tensor:
    """(..., scales+3, H, W) Gaussian stack for one octave (level 0 = base)."""
    H, W = base.shape[-2:]
    Bv, Bh = _octave_mats_on(H, W, scales, float(sigma0), base.device)
    # one (frames*H, W) @ (W, W) product per level, then the vertical pass
    levels = [mm(Bv[c].T, mm(base, Bh[c])) for c in range(Bh.shape[0])]
    return torch.stack([base, *levels], dim=-3)


def downsample_2x(img: torch.Tensor) -> torch.Tensor:
    return img[..., ::2, ::2].contiguous()


def upsample_2x(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of (..., H, W), half-pixel centres, edges
    clamped: what `jax.image.resize(img, (2H, 2W), "linear")` computes."""
    H, W = img.shape[-2:]
    out = F.interpolate(
        img.reshape(-1, 1, H, W), size=(2 * H, 2 * W), mode="bilinear",
        align_corners=False,
    )
    return out.reshape(*img.shape[:-2], 2 * H, 2 * W)


def build_pyramid(
    img: torch.Tensor,
    num_octaves: int,
    scales: int,
    sigma0: float = 1.6,
    assumed_blur: float = 0.5,
    first_octave: int = 0,
    impl: str = "auto",
):
    """Full Gaussian + DoG pyramids of (..., H, W) float32 images.

    Returns (gauss, dogs): lists over octaves of (..., scales+3, Ho, Wo)
    and (..., scales+2, Ho, Wo). Like OpenCV SIFT, the input is
    pre-blurred up to sigma0 assuming `assumed_blur` sensor blur.

    `first_octave=-1` adds cv2.SIFT's upsampled base octave (bilinear 2x;
    the assumed sensor blur doubles); mapping coordinates back to input
    pixels is the caller's job via 2^(o + first_octave). `impl`: "auto" and
    "matmul" run the band matmuls (the only route here).
    """
    if first_octave not in (0, -1):
        raise ValueError(f"build_pyramid: first_octave must be 0 or -1, not {first_octave}")
    if impl not in ("auto", "matmul"):
        raise ValueError(f"build_pyramid: unknown impl {impl!r}")
    img = img.to(torch.float32)
    if first_octave == -1:
        img = upsample_2x(img)
        assumed_blur = 2.0 * assumed_blur
    sig_diff = math.sqrt(max(sigma0**2 - assumed_blur**2, 1e-8))
    base = blur_2d(img, sig_diff)
    octave = build_gaussian_octave
    gauss, dogs = [], []
    for _ in range(num_octaves):
        stack = octave(base, sigma0, scales)
        gauss.append(stack)
        dogs.append(stack[..., 1:, :, :] - stack[..., :-1, :, :])
        # next octave seeds from the level with 2*sigma0 blur
        base = downsample_2x(stack[..., scales, :, :])
    return gauss, dogs
