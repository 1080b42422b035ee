"""SIFT-style keypoint detector + descriptor at fixed shape.

Port of visualodometry_tpu/frontend/sift.py: DoG
extrema by separable shifted compares, per-octave exact top-K into fixed
slots, one-step quadratic subpixel refinement, a 36-bin orientation
histogram and the 4x4x8 descriptor, all batched over keypoints.

Tap sampling has two paths that read the same bf16 gradient values:
- "gather": flat indexing into a row-packed (Lvl*H*W, 2) bf16 field;
- "patch": kernel K2 (ops/patches.py) copies one (P+8, P) window of the
  packed int32 field per keypoint, and taps index into that window.
`sift_sampling="auto"` takes the patch path on CUDA and the gather path on
the CPU. The JAX patch sampler selects taps with one-hot einsums to dodge
TPU gathers; on the card a direct index into the (K, 2, Py, Px) patch
gives the same bf16 values, because one-hot selection is exact. Its
clip-to-image-then-rebase order and separable orientation grid are kept.

Top-k is an exact `torch.topk` (the JAX CPU path's `_topk_hier` is exact
on these inputs); tie order among equal scores is unspecified on CUDA, so
comparisons hold keypoints over valid slots only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.ops.patches import extract_patches
from visualodometry_tpu_torch.ops.pyramid import build_pyramid

_NUM_BINS = 36
_DESC_GRID = 4  # 4x4 spatial bins
_DESC_BINS = 8  # orientation bins
_SAMPLES = 16  # 16x16 descriptor sample grid
_ORI_SAMPLES = 16  # 16x16 orientation sample grid


class OctaveKeypoints(NamedTuple):
    xy: torch.Tensor  # (K, 2) octave-pixel coords (x, y), subpixel
    scale_idx: torch.Tensor  # (K,) int64 DoG layer index in [1, S]
    sigma_rel: torch.Tensor  # (K,) octave-relative blur of the keypoint
    response: torch.Tensor  # (K,)
    valid: torch.Tensor  # (K,)


def _extrema_mask(dogs: torch.Tensor, thr: float, edge_thresh: float):
    """Candidate mask + |response| over DoG layers 1..S.

    dogs: (S+2, H, W). Returns (mask, score): (S, H, W) each.
    """
    S2, H, W = dogs.shape

    def _sep3(a, op, fill):
        a = op(op(a[:-2], a[1:-1]), a[2:])  # s axis, VALID
        p = F.pad(a, (0, 0, 1, 1), value=fill)
        a = op(op(p[:, :-2], p[:, 1:-1]), p[:, 2:])  # h axis, SAME
        p = F.pad(a, (1, 1), value=fill)
        return op(op(p[:, :, :-2], p[:, :, 1:-1]), p[:, :, 2:])

    mx = _sep3(dogs, torch.maximum, -math.inf)  # (S, H, W)
    mn = _sep3(dogs, torch.minimum, math.inf)
    center = dogs[1:-1]
    is_max = (center >= mx) & (center > thr)
    is_min = (center <= mn) & (center < -thr)
    cand = is_max | is_min

    # edge rejection: 2x2 spatial Hessian ratio test on the center layer
    d = center
    dxx = torch.roll(d, -1, 2) + torch.roll(d, 1, 2) - 2 * d
    dyy = torch.roll(d, -1, 1) + torch.roll(d, 1, 1) - 2 * d
    dxy = 0.25 * (
        torch.roll(torch.roll(d, -1, 1), -1, 2)
        + torch.roll(torch.roll(d, 1, 1), 1, 2)
        - torch.roll(torch.roll(d, -1, 1), 1, 2)
        - torch.roll(torch.roll(d, 1, 1), -1, 2)
    )
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) * (r + 1.0) * det)
    cand = cand & edge_ok

    # exclude the image border (refinement/descriptor windows need margin)
    border = 8
    mask2d = torch.zeros((H, W), dtype=torch.bool, device=dogs.device)
    mask2d[border : H - border, border : W - border] = True
    cand = cand & mask2d[None, :, :]
    return cand, torch.abs(center)


def _refine_subpixel(dogs, s, y, x):
    """One Newton step of the 3D quadratic fit at (s, y, x) (batched).

    Returns (ds, dy, dx, refined_value), each (K,), offsets clipped to ±0.5.
    """
    S2, H, W = dogs.shape
    flat = dogs.reshape(-1)
    s = torch.clamp(s, 1, S2 - 2)
    y = torch.clamp(y, 1, H - 2)
    x = torch.clamp(x, 1, W - 2)
    base = (s * H + y) * W + x  # (K,)
    # 27 neighbour offsets, (ds, dy, dx) row-major; built on the device
    # (a host list would be copied over with a synchronisation)
    r = torch.arange(-1, 2, dtype=base.dtype, device=base.device)
    offs = ((r[:, None, None] * H + r[None, :, None]) * W + r[None, None, :]).reshape(-1)
    c = flat[base[:, None] + offs[None, :]].reshape(-1, 3, 3, 3)
    g = torch.stack(
        [
            0.5 * (c[:, 2, 1, 1] - c[:, 0, 1, 1]),
            0.5 * (c[:, 1, 2, 1] - c[:, 1, 0, 1]),
            0.5 * (c[:, 1, 1, 2] - c[:, 1, 1, 0]),
        ],
        dim=-1,
    )
    v = c[:, 1, 1, 1]
    dss = c[:, 2, 1, 1] + c[:, 0, 1, 1] - 2 * v
    dyy = c[:, 1, 2, 1] + c[:, 1, 0, 1] - 2 * v
    dxx = c[:, 1, 1, 2] + c[:, 1, 1, 0] - 2 * v
    dsy = 0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1])
    dsx = 0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0])
    dyx = 0.25 * (c[:, 1, 2, 2] - c[:, 1, 2, 0] - c[:, 1, 0, 2] + c[:, 1, 0, 0])
    # closed-form symmetric 3x3 solve (adjugate / Cramer)
    a = dss + 1e-6
    d = dyy + 1e-6
    f = dxx + 1e-6
    b, cc, e = dsy, dsx, dyx
    A = d * f - e * e
    B = cc * e - b * f
    C = b * e - cc * d
    D = a * f - cc * cc
    E = b * cc - a * e
    Fm = a * d - b * b
    det = a * A + b * B + cc * C
    inv_det = 1.0 / torch.where(
        torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20)
    )
    g0, g1, g2 = -g[:, 0], -g[:, 1], -g[:, 2]
    offset = torch.stack(
        [
            (A * g0 + B * g1 + C * g2) * inv_det,
            (B * g0 + D * g1 + E * g2) * inv_det,
            (C * g0 + E * g1 + Fm * g2) * inv_det,
        ],
        dim=-1,
    )
    offset = torch.clamp(offset, -0.5, 0.5)
    refined = v + 0.5 * torch.sum(g * offset, dim=-1)
    return offset[:, 0], offset[:, 1], offset[:, 2], refined


def detect_octave(dogs: torch.Tensor, cfg: VOConfig, k_octave: int) -> OctaveKeypoints:
    """Fixed-K keypoint detection in one octave's DoG stack (S+2, H, W)."""
    S = cfg.sift_scales_per_octave
    thr = 0.5 * cfg.sift_contrast_threshold / S
    cand, score = _extrema_mask(dogs, thr, cfg.sift_edge_threshold)
    Sc, H, W = score.shape
    flat = torch.where(cand, score, -1.0).reshape(-1)
    top_scores, top_idx = torch.topk(flat, k_octave)
    valid = top_scores > 0
    s_idx = top_idx // (H * W) + 1  # DoG layer in [1, S]
    rem = top_idx % (H * W)
    y = rem // W
    x = rem % W

    ds, dy, dx, refined = _refine_subpixel(dogs, s_idx, y, x)
    # final contrast test on the interpolated value (OpenCV semantics)
    valid = valid & (torch.abs(refined) * S >= cfg.sift_contrast_threshold)

    xf = x.to(dogs.dtype) + dx
    yf = y.to(dogs.dtype) + dy
    sf = s_idx.to(dogs.dtype) + ds
    sigma_rel = cfg.sift_sigma * (2.0 ** (sf / S))
    return OctaveKeypoints(
        xy=torch.stack([xf, yf], dim=-1),
        scale_idx=s_idx,
        sigma_rel=sigma_rel,
        response=torch.abs(refined),
        valid=valid,
    )


def _gradients(stack: torch.Tensor):
    """Central-difference gradients per level of (Lvl, H, W)."""
    gx = 0.5 * (torch.roll(stack, -1, 2) - torch.roll(stack, 1, 2))
    gy = 0.5 * (torch.roll(stack, -1, 1) - torch.roll(stack, 1, 1))
    return gx, gy


def _nearest_grad_pair(grad_packed, H: int, W: int, lvl, x, y):
    """Nearest-pixel (gx, gy) sample from a packed (Lvl*H*W, 2) bf16 field."""
    xi = torch.clamp(torch.round(x), 0.0, W - 1.0).long()
    yi = torch.clamp(torch.round(y), 0.0, H - 1.0).long()
    idx = (lvl[:, None] * H + yi) * W + xi
    g2 = grad_packed[idx].to(torch.float32)  # (K, M, 2)
    return g2[..., 0], g2[..., 1]


def _pack_gradients(gauss: torch.Tensor):
    """Per-level central-difference gradients, packed (Lvl*H*W, 2) bf16."""
    gx, gy = _gradients(gauss)
    return torch.stack([gx, gy], dim=-1).to(torch.bfloat16).reshape(-1, 2)


def _pack_gradients_planar(gauss: torch.Tensor, h_pad: int, w_pad: int):
    """The same gradient field, packed (Lvl, h_pad, w_pad) int32.

    The (gx, gy) bf16 pair is bitcast into one 32-bit word per pixel (gx in
    the low half), so each keypoint's taps lie in one contiguous window
    for K2. Zero padding to (h_pad, w_pad) keeps the JAX layout (whose
    Mosaic kernel needed tile multiples); padding pixels are never
    sampled because taps are clipped to the true image first.
    """
    gx, gy = _gradients(gauss)
    pair = torch.stack([gx.to(torch.bfloat16), gy.to(torch.bfloat16)], dim=-1)
    field = pair.view(torch.int32)[..., 0]  # (L, H, W)
    L, H, W = field.shape
    assert h_pad >= H and w_pad >= W
    if h_pad != H or w_pad != W:
        field = F.pad(field, (0, w_pad - W, 0, h_pad - H))
    return field.contiguous()


def _unpack_patches(patches_i32: torch.Tensor) -> torch.Tensor:
    """(K, Py, Px) int32 -> (K, 2, Py, Px) bf16 gradient patches."""
    K, Py, Px = patches_i32.shape
    pair = patches_i32.view(torch.bfloat16).reshape(K, Py, Px, 2)
    return pair.permute(0, 3, 1, 2)


def _patch_margin(cfg: VOConfig) -> int:
    """Upper bound (pixels) on any orientation/descriptor tap offset."""
    S = cfg.sift_scales_per_octave
    sigma_max = cfg.sift_sigma * 2.0 ** ((S + 0.5) / S)
    desc_off = (2.0**0.5) * 1.875 * 3.0 * sigma_max
    lin_max = (_ORI_SAMPLES - 1) / _ORI_SAMPLES
    ori_off = 2.5 * 1.5 * sigma_max * lin_max
    return int(math.ceil(max(desc_off, ori_off)))


def _patch_origins(kps: OctaveKeypoints, H: int, W: int, h_pad: int, P: int):
    """Window origins so each keypoint sits (P/2-1, P/2) into its patch.

    The same origins as the JAX path (row origin aligned down to 8 and the
    window made 8 rows taller), which keeps the patch path bit-identical
    to the gather path.
    """
    x0 = torch.clamp(
        torch.floor(kps.xy[:, 0]).to(torch.int32) - (P // 2 - 1), 0, W - P
    )
    y0 = torch.clamp(
        torch.floor(kps.xy[:, 1]).to(torch.int32) - (P // 2 - 1), 0, H - P
    )
    y0 = torch.clamp(y0 & ~7, 0, h_pad - (P + 8))
    return y0, x0


def _make_patch_sampler(patches, y0, x0, H: int, W: int):
    """Nearest-tap (gx, gy) sampler over per-keypoint gradient patches.

    patches: (K, 2, Py, Px) bf16. Taps are clipped to the true image
    extent first (the gather path's clip), then rebased into the patch and
    read by direct index.
    """
    K, C, Py, Px = patches.shape
    # pair-last (K, Py*Px, 2): for `_unpack_patches` output this is the
    # kernel's own layout, so no copy is made
    flat = patches.permute(0, 2, 3, 1).reshape(K, Py * Px, C)
    y0 = y0.long()
    x0 = x0.long()

    def _read(idx):  # idx: (K, M) flat patch index
        g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        g = g.to(torch.float32)
        return g[..., 0], g[..., 1]

    def sample(xs, ys):
        xi_abs = torch.clamp(torch.round(xs), 0.0, W - 1.0).long()
        yi_abs = torch.clamp(torch.round(ys), 0.0, H - 1.0).long()
        xi = torch.clamp(xi_abs - x0[:, None], 0, Px - 1)
        yi = torch.clamp(yi_abs - y0[:, None], 0, Py - 1)
        return _read(yi * Px + xi)

    def sample_separable(xs_col, ys_row):
        """Taps on an axis-aligned grid: (K, Mx) columns x (K, My) rows,
        returned flattened row-major (y outer, x inner)."""
        xi_abs = torch.clamp(torch.round(xs_col), 0.0, W - 1.0).long()
        yi_abs = torch.clamp(torch.round(ys_row), 0.0, H - 1.0).long()
        xi = torch.clamp(xi_abs - x0[:, None], 0, Px - 1)  # (K, Mx)
        yi = torch.clamp(yi_abs - y0[:, None], 0, Py - 1)  # (K, My)
        idx = (yi[:, :, None] * Px + xi[:, None, :]).reshape(K, -1)
        return _read(idx)

    sample.separable = sample_separable
    return sample


def orientation_histogram(gauss, kps: OctaveKeypoints, grad_packed=None, sampler=None):
    """Smoothed 36-bin gradient-orientation histogram per keypoint."""
    S_levels, H, W = gauss.shape
    if sampler is None and grad_packed is None:
        grad_packed = _pack_gradients(gauss)
    dev = gauss.device
    K = kps.xy.shape[0]
    M = _ORI_SAMPLES
    lin = (torch.arange(M, dtype=torch.float32, device=dev) - (M - 1) / 2.0) / (M / 2.0)
    dv, du = torch.meshgrid(lin, lin, indexing="ij")  # du varies along x
    du = du.reshape(-1)
    dv = dv.reshape(-1)

    sigma_w = 1.5 * kps.sigma_rel
    radius = 2.5 * sigma_w
    if sampler is not None:
        # the orientation grid is axis-aligned: per-axis selection
        gxs, gys = sampler.separable(
            kps.xy[:, 0:1] + radius[:, None] * lin[None, :],
            kps.xy[:, 1:2] + radius[:, None] * lin[None, :],
        )
    else:
        xs = kps.xy[:, 0:1] + radius[:, None] * du[None, :]
        ys = kps.xy[:, 1:2] + radius[:, None] * dv[None, :]
        lvl = torch.clamp(kps.scale_idx, 0, S_levels - 1)
        gxs, gys = _nearest_grad_pair(grad_packed, H, W, lvl, xs, ys)

    mag = torch.sqrt(gxs * gxs + gys * gys)
    ang = torch.atan2(gys, gxs)
    r2 = du * du + dv * dv
    gw = torch.exp(-r2[None, :] * (2.5**2) / (2.0 * 1.5**2))
    w = mag * gw

    bins = (
        torch.floor((ang + math.pi) / (2 * math.pi) * _NUM_BINS).long() % _NUM_BINS
    )
    # factorized one-hot contraction (as the JAX path): one_hot(b, 36) ==
    # one_hot(b // 6, 6) x one_hot(b % 6, 6); a batched matmul keeps the
    # sum order fixed (a scatter-add on CUDA would not)
    # (comparisons, not F.one_hot, whose bounds check reads back to the host)
    six = torch.arange(6, device=dev)
    q = (bins[..., None] // 6 == six).to(w.dtype)  # (K, 256, 6)
    r = (bins[..., None] % 6 == six).to(w.dtype)
    hist = ((q * w[..., None]).transpose(1, 2) @ r).reshape(K, _NUM_BINS)

    def smooth(h):
        return (
            6 * h
            + 4 * (torch.roll(h, 1, -1) + torch.roll(h, -1, -1))
            + (torch.roll(h, 2, -1) + torch.roll(h, -2, -1))
        ) / 16.0

    return smooth(smooth(hist))


def _hist_peak_angle(hist, peak):
    """Parabolic-interpolated angle of histogram bin `peak` (batched)."""
    hp = torch.gather(hist, -1, peak[:, None])[:, 0]
    hl = torch.gather(hist, -1, ((peak - 1) % _NUM_BINS)[:, None])[:, 0]
    hr = torch.gather(hist, -1, ((peak + 1) % _NUM_BINS)[:, None])[:, 0]
    denom = hl - 2 * hp + hr
    safe = torch.abs(denom) > 1e-12
    delta = torch.where(
        safe, 0.5 * (hl - hr) / torch.where(safe, denom, 1.0), 0.0
    )
    bin_f = peak.to(hist.dtype) + torch.clamp(delta, -0.5, 0.5)
    return (bin_f + 0.5) / _NUM_BINS * 2 * math.pi - math.pi, hp


def second_peak_orientation(hist):
    """Top-2 orientation peaks (theta1, theta2, has2) from a histogram."""
    peak1 = torch.argmax(hist, dim=-1)
    theta1, h1 = _hist_peak_angle(hist, peak1)
    is_localmax = (hist >= torch.roll(hist, 1, -1)) & (
        hist >= torch.roll(hist, -1, -1)
    )
    idx = torch.arange(_NUM_BINS, device=hist.device)
    d = torch.abs(idx[None, :] - peak1[:, None])
    d = torch.minimum(d, _NUM_BINS - d)
    cand = is_localmax & (d > 1) & (hist >= 0.8 * h1[:, None])
    peak2 = torch.argmax(torch.where(cand, hist, -math.inf), dim=-1)
    has2 = torch.any(cand, dim=-1)
    theta2, _ = _hist_peak_angle(hist, peak2)
    return theta1, theta2, has2


def compute_descriptors(gauss, kps: OctaveKeypoints, theta, grad_packed=None, sampler=None):
    """128-D descriptors: 4x4 spatial x 8 orientation bins, batched."""
    S_levels, H, W = gauss.shape
    if sampler is None and grad_packed is None:
        grad_packed = _pack_gradients(gauss)
    dev = gauss.device
    K = kps.xy.shape[0]
    hist_width = 3.0 * kps.sigma_rel
    lin = (
        (torch.arange(_SAMPLES, dtype=torch.float32, device=dev) + 0.5)
        / _SAMPLES * _DESC_GRID - _DESC_GRID / 2
    )
    gv, gu = torch.meshgrid(lin, lin, indexing="ij")
    gu = gu.reshape(-1)
    gv = gv.reshape(-1)

    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    ox = (cos_t[:, None] * gu[None, :] - sin_t[:, None] * gv[None, :]) * hist_width[:, None]
    oy = (sin_t[:, None] * gu[None, :] + cos_t[:, None] * gv[None, :]) * hist_width[:, None]
    xs = kps.xy[:, 0:1] + ox
    ys = kps.xy[:, 1:2] + oy

    if sampler is not None:
        gxs, gys = sampler(xs, ys)
    else:
        lvl = torch.clamp(kps.scale_idx, 0, S_levels - 1)
        gxs, gys = _nearest_grad_pair(grad_packed, H, W, lvl, xs, ys)

    mag = torch.sqrt(gxs * gxs + gys * gys)
    ang = torch.atan2(gys, gxs) - theta[:, None]
    r2 = gu * gu + gv * gv
    gw = torch.exp(-r2[None, :] / (2.0 * (_DESC_GRID / 2) ** 2))
    w = mag * gw  # (K, 256)

    ub = gu + _DESC_GRID / 2 - 0.5
    vb = gv + _DESC_GRID / 2 - 0.5
    ob = torch.remainder((ang + math.pi) / (2 * math.pi) * _DESC_BINS, _DESC_BINS)

    pu = torch.arange(_DESC_GRID, dtype=w.dtype, device=dev)
    hat_u = torch.clamp(1.0 - torch.abs(ub[:, None] - pu[None, :]), min=0.0)
    hat_v = torch.clamp(1.0 - torch.abs(vb[:, None] - pu[None, :]), min=0.0)
    A = (hat_v[:, :, None] * hat_u[:, None, :]).reshape(
        _SAMPLES * _SAMPLES, _DESC_GRID * _DESC_GRID
    )  # (256, 16), constant across keypoints

    po = torch.arange(_DESC_BINS, dtype=w.dtype, device=dev)
    do = torch.abs(ob[..., None] - po)  # (K, 256, 8)
    do = torch.minimum(do, _DESC_BINS - do)
    B = torch.clamp(1.0 - do, min=0.0)

    # desc[k, p, o] = sum_s w[k,s] A[s,p] B[k,s,o]: one batched matmul
    desc = ((w[:, :, None] * A[None]).transpose(1, 2) @ B).reshape(
        K, _DESC_GRID * _DESC_GRID * _DESC_BINS
    )
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=1e-8)
    desc = torch.clamp(desc, max=0.2)
    norm2 = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return desc / torch.clamp(norm2, min=1e-8)


def _octave_budgets(total: int, num_octaves: int) -> list[int]:
    """Split the keypoint budget over octaves, halving per octave."""
    budgets = []
    remaining = total
    for o in range(num_octaves):
        if o == num_octaves - 1:
            budgets.append(remaining)
        else:
            b = max(total // (2 ** (o + 1)), 1)
            budgets.append(b)
            remaining -= b
    return budgets


def _to_float_images(imgs: torch.Tensor) -> torch.Tensor:
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) * (1.0 / 255.0)
    return imgs.to(torch.float32)


def extract_sift_from_pyramid(pyr_pair, cfg: VOConfig) -> Features:
    """Detection + orientation + descriptors over one frame's pyramid.

    pyr_pair: (gauss, dogs) lists over octaves of (C, H, W) tensors.
    """
    gauss, dogs = pyr_pair
    total = cfg.padded_keypoints
    peaks = cfg.sift_orientation_peaks
    budgets = _octave_budgets(total // peaks, cfg.sift_num_octaves)

    mode = cfg.sift_sampling
    on_cuda = gauss[0].device.type == "cuda"
    want_patch = mode == "patch" or (mode == "auto" and on_cuda)
    P = -(-(2 * (_patch_margin(cfg) + 1)) // 8) * 8  # margin <= P//2 - 1

    all_xy, all_desc, all_valid = [], [], []
    for o in range(cfg.sift_num_octaves):
        kps = detect_octave(dogs[o], cfg, budgets[o])
        _, H_o, W_o = gauss[o].shape
        h_pad = -(-H_o // 8) * 8
        w_pad = max(-(-W_o // 128) * 128, ((P + 127) // 128) * 128 + 128)
        fits = h_pad >= P + 8 and budgets[o] % 8 == 0
        if want_patch and fits:
            field = _pack_gradients_planar(gauss[o], h_pad, w_pad)
            y0, x0 = _patch_origins(kps, H_o, W_o, h_pad, P)
            lvl = torch.clamp(kps.scale_idx, 0, field.shape[0] - 1).to(torch.int32)
            # origins are clamped in-bounds above: skip the checking sync
            patches = _unpack_patches(
                extract_patches(
                    field, lvl, y0, x0, patch_y=P + 8, patch_x=P,
                    check_bounds=False,
                )
            )
            sampler = _make_patch_sampler(patches, y0, x0, H_o, W_o)
            grad_packed = None
        else:
            grad_packed = _pack_gradients(gauss[o])
            sampler = None
        hist = orientation_histogram(gauss[o], kps, grad_packed, sampler)
        if peaks == 1:
            theta, _ = _hist_peak_angle(hist, torch.argmax(hist, dim=-1))
            thetas_valids = [(theta, kps.valid)]
        else:
            theta1, theta2, has2 = second_peak_orientation(hist)
            thetas_valids = [(theta1, kps.valid), (theta2, kps.valid & has2)]
        for theta, valid in thetas_valids:
            desc = compute_descriptors(gauss[o], kps, theta, grad_packed, sampler)
            all_xy.append(kps.xy * (2.0 ** (o + cfg.sift_first_octave)))
            all_desc.append(desc)
            all_valid.append(valid)

    return Features(
        kps=torch.cat(all_xy, dim=0),
        desc=torch.cat(all_desc, dim=0),
        valid=torch.cat(all_valid, dim=0),
    )


def _pyramid(imgs: torch.Tensor, cfg: VOConfig, impl: str):
    return build_pyramid(
        _to_float_images(imgs),
        cfg.sift_num_octaves,
        cfg.sift_scales_per_octave,
        sigma0=cfg.sift_sigma,
        first_octave=cfg.sift_first_octave,
        impl=impl,
    )


def extract_sift(
    img: torch.Tensor, cfg: VOConfig, device=None, pyramid_impl: str = "auto"
) -> Features:
    """(H, W) image (float in [0, 1] or uint8) -> fixed-shape SIFT Features.

    Runs on `device` (CUDA unless "cpu" is asked for). `pyramid_impl` is
    `build_pyramid`'s `impl` argument, handed on unchanged.
    """
    img = img.to(resolve_device(device))
    gauss, dogs = _pyramid(img, cfg, pyramid_impl)
    return extract_sift_from_pyramid((gauss, dogs), cfg)


def make_batched_extract_fn(cfg: VOConfig, device=None, pyramid_impl: str = "auto"):
    """Chunk extractor: one pyramid batched over the chunk's frames, then
    detection / sampling / description frame by frame.

    Returns `extract_batch(imgs (C, H, W)) -> list of C Features`.
    `pyramid_impl` is `build_pyramid`'s `impl` argument.
    """
    dev = resolve_device(device)

    def extract_batch(imgs: torch.Tensor) -> list[Features]:
        gauss, dogs = _pyramid(imgs.to(dev), cfg, pyramid_impl)
        return [
            extract_sift_from_pyramid(
                ([g[i] for g in gauss], [d[i] for d in dogs]), cfg
            )
            for i in range(imgs.shape[0])
        ]

    return extract_batch
