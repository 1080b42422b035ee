"""SuperPoint keypoint detector/descriptor in PyTorch.

Port of visualodometry_tpu/models/superpoint.py: the VGG-style encoder with
either the 65-channel cell-softmax detector head (`SuperPointBackbone`) or
the dense full-resolution scoring head (`SuperPointDense`), and the 256-D
descriptor head; then NMS as a max-pool equality, top-K into fixed slots,
3x3 soft-argmax refinement, optional Förstner refinement, and bilinear
descriptor sampling.

Layout: the modules are NCHW (input (B, 1, H, W), H and W multiples of 8);
the functions below keep the JAX package's layouts (heatmap (H, W), coarse
descriptors (H/8, W/8, 256)), so each compares with its JAX counterpart
directly.

Precision: the backbone runs in `compute_dtype`, bf16 by default, as the
JAX package casts weights and input at the call. Every convolution is the
product then the bias, each rounded to `compute_dtype`, as Flax's `Conv`
does. Post-processing is float32.

Selection is an exact `torch.topk`. The JAX package's `_topk_hier` is exact
only when no 1024-pixel group holds more than 256 of the top K, and breaks
ties toward the lower index where `torch.topk` leaves their order open; so
the two can differ in which of several equal scores fill the last slots
and in the order of slots, never in the set of scores above a tie.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vobench.reference._device import resolve_device
from vobench.reference.frontend.interface import Features
from vobench.reference.precision import LOWERED, round_fp8


def _conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Flax `Conv` with "SAME" padding in x's dtype: product, then bias.
    Under the control's lowered precision, weights and input go through
    float8 first (vobench/reference/precision.py)."""
    w = layer.weight.to(x.dtype)
    if LOWERED["fp8"]:
        w, x = round_fp8(w), round_fp8(x)
    y = F.conv2d(x, w, None, padding=layer.kernel_size[0] // 2)
    return y + layer.bias.to(x.dtype)[:, None, None]


def _block(a: nn.Conv2d, b: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(_conv(b, torch.relu(_conv(a, x))))


def _normalize_channels(desc: torch.Tensor) -> torch.Tensor:
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-8)


class _Encoder(nn.Module):
    """Shared VGG encoder and the 256-D descriptor head."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in (
            ("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64), ("conv2b", 64, 64),
            ("conv3a", 64, 128), ("conv3b", 128, 128), ("conv4a", 128, 128),
            ("conv4b", 128, 128),
        ):
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.convDa = nn.Conv2d(128, 256, 3, padding=1)
        self.convDb = nn.Conv2d(256, 256, 1)

    def encode(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The four scales' features, full resolution down to 1/8."""
        x1 = _block(self.conv1a, self.conv1b, x)
        x2 = _block(self.conv2a, self.conv2b, F.max_pool2d(x1, 2, 2))
        x3 = _block(self.conv3a, self.conv3b, F.max_pool2d(x2, 2, 2))
        x4 = _block(self.conv4a, self.conv4b, F.max_pool2d(x3, 2, 2))
        return [x1, x2, x3, x4]

    def describe(self, x4: torch.Tensor) -> torch.Tensor:
        desc = _conv(self.convDb, torch.relu(_conv(self.convDa, x4)))
        return _normalize_channels(desc)


class SuperPointBackbone(_Encoder):
    """Encoder + cell-softmax detector head + descriptor head.

    forward(x (B, 1, H, W)) -> (det (B, 65, H/8, W/8) logits,
    desc (B, 256, H/8, W/8) unit vectors), both in x's dtype.
    """

    def __init__(self):
        super().__init__()
        self.convPa = nn.Conv2d(128, 256, 3, padding=1)
        self.convPb = nn.Conv2d(256, 65, 1)

    def forward(self, x: torch.Tensor):
        x4 = self.encode(x)[3]
        det = _conv(self.convPb, torch.relu(_conv(self.convPa, x4)))
        return det, self.describe(x4)


class SuperPointDense(_Encoder):
    """Encoder + dense full-resolution scoring head + descriptor head.

    Each encoder scale is projected to 8 channels by a 1x1 convolution,
    upsampled bilinearly to full resolution (half-pixel centres, as
    `jax.image.resize`), concatenated and mixed by two 3x3 convolutions
    into one score logit a pixel.

    forward(x (B, 1, H, W)) -> (score (B, H, W) logits,
    desc (B, 256, H/8, W/8) unit vectors), both in x's dtype.
    """

    def __init__(self):
        super().__init__()
        for i, cin in enumerate((64, 64, 128, 128), start=1):
            setattr(self, f"score{i}", nn.Conv2d(cin, 8, 1))
        self.scoreMixA = nn.Conv2d(32, 16, 3, padding=1)
        self.scoreMixB = nn.Conv2d(16, 1, 3, padding=1)

    def forward(self, x: torch.Tensor):
        scales = self.encode(x)
        H, W = x.shape[-2:]
        feats = []
        for i, xs in enumerate(scales, start=1):
            s = _conv(getattr(self, f"score{i}"), xs)
            if xs.shape[-2] != H:
                s = F.interpolate(s, size=(H, W), mode="bilinear", align_corners=False)
            feats.append(s)
        s = torch.relu(_conv(self.scoreMixA, torch.cat(feats, dim=1)))
        score = _conv(self.scoreMixB, s)[:, 0]
        return score, self.describe(scales[3])


class SuperPointOutput(NamedTuple):
    heatmap: torch.Tensor  # (H, W) keypoint probability
    coarse_desc: torch.Tensor  # (H/8, W/8, 256) normalized


def is_dense_params(params) -> bool:
    """True when a Flax params tree belongs to SuperPointDense."""
    try:
        return "scoreMixB" in params["params"]
    except (KeyError, TypeError):
        return False


def heatmap_from_logits(det_logits: torch.Tensor) -> torch.Tensor:
    """(..., Hc, Wc, 65) logits -> (..., H, W) probabilities: softmax, drop
    the dustbin, depth-to-space with the 64 cells row-major in the 8x8
    block."""
    prob = torch.softmax(det_logits, dim=-1)[..., :64]
    *lead, hc, wc, _ = prob.shape
    prob = prob.reshape(*lead, hc, wc, 8, 8).transpose(-3, -2)
    return prob.reshape(*lead, hc * 8, wc * 8)


def nms_heatmap(heat: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Keep values equal to their (2r+1)^2 window's max (the window padded
    with -inf), zero the rest. heat: (H, W) or (B, H, W)."""
    k = 2 * radius + 1
    pooled = F.max_pool2d(heat[None] if heat.dim() == 2 else heat, k, 1, radius)
    return torch.where(heat >= pooled.reshape(heat.shape), heat, 0.0)


def _window(a: torch.Tensor, y: torch.Tensor, x: torch.Tensor, r: int) -> torch.Tensor:
    """(K, 2r+1, 2r+1) windows of a (H, W) map at centres (y, x), which the
    caller keeps r pixels inside the map."""
    d = torch.arange(-r, r + 1, device=a.device)
    return a[(y[:, None, None] + d[None, :, None]), (x[:, None, None] + d[None, None, :])]


def _forstner_refine(img: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor, radius: int = 3):
    """Batched Förstner subpixel corner localization.

    For each integer detection, the weighted least-squares intersection of
    the gradient lines in its (2r+1)^2 window, p* = (sum g g^T)^-1
    (sum g g^T x), as one closed-form 2x2 solve. Returns (xs, ys), NaN
    where the structure tensor is degenerate or the shift is 1.5 px or
    more (those keep their heatmap-refined position).
    """
    H, W = img.shape
    gx = F.pad(0.5 * (img[:, 2:] - img[:, :-2]), (1, 1, 0, 0))
    gy = F.pad(0.5 * (img[2:, :] - img[:-2, :]), (0, 0, 1, 1))
    y0 = torch.clamp(yi, radius, H - radius - 1)
    x0 = torch.clamp(xi, radius, W - radius - 1)
    wx, wy = _window(gx, y0, x0, radius), _window(gy, y0, x0, radius)
    d = torch.arange(-radius, radius + 1, device=img.device, dtype=torch.float32)
    dj, di = d[None, None, :], d[None, :, None]
    a, b, c = wx * wx, wx * wy, wy * wy
    Sxx, Sxy, Syy = a.sum((1, 2)), b.sum((1, 2)), c.sum((1, 2))
    bx = (a * dj + b * di).sum((1, 2))
    by = (b * dj + c * di).sum((1, 2))
    det = Sxx * Syy - Sxy * Sxy
    trace = Sxx + Syy
    ok = det > 1e-4 * trace * trace + 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    dx = (Syy * bx - Sxy * by) * inv_det
    dy = (Sxx * by - Sxy * bx) * inv_det
    ok = ok & (torch.sqrt(dx * dx + dy * dy) < 1.5)
    nan = torch.full_like(dx, float("nan"))
    return torch.where(ok, x0 + dx, nan), torch.where(ok, y0 + dy, nan)


def select_keypoints(
    heat: torch.Tensor,
    coarse_desc: torch.Tensor,
    max_keypoints: int,
    threshold: float = 0.005,
    border: int = 4,
    img: torch.Tensor | None = None,
) -> Features:
    """Top-K over the NMS'd heatmap + bilinear descriptor sampling.

    heat: (H, W) float32; coarse_desc: (H/8, W/8, D) float32; img: the
    (padded) image for Förstner refinement, or None.
    """
    H, W = heat.shape
    nms = nms_heatmap(heat)
    nms = F.pad(nms[border : H - border, border : W - border], (border,) * 4)
    scores, idx = torch.topk(nms.reshape(-1), max_keypoints)
    yi, xi = idx // W, idx % W
    valid = scores > threshold

    # 3x3 soft-argmax on the raw (pre-NMS) heatmap
    y0 = torch.clamp(yi, 1, H - 2)
    x0 = torch.clamp(xi, 1, W - 2)
    win = _window(heat, y0, x0, 1)
    d = torch.arange(-1, 2, device=heat.device, dtype=torch.float32)
    wsum = torch.clamp(win.sum((1, 2)), min=1e-12)
    ox = (win * d[None, None, :]).sum((1, 2))
    oy = (win * d[None, :, None]).sum((1, 2))
    xs = x0.to(torch.float32) + torch.clamp(ox / wsum, -0.5, 0.5)
    ys = y0.to(torch.float32) + torch.clamp(oy / wsum, -0.5, 0.5)

    if img is not None:
        fx, fy = _forstner_refine(img, xi, yi)
        xs = torch.where(torch.isnan(fx), xs, fx)
        ys = torch.where(torch.isnan(fy), ys, fy)

    # bilinear sample of the coarse descriptor grid
    hc, wc, _ = coarse_desc.shape
    gx = torch.clamp(xs / 8.0 - 0.5, 0.0, wc - 1.001)
    gy = torch.clamp(ys / 8.0 - 0.5, 0.0, hc - 1.001)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    desc = (
        coarse_desc[y0, x0] * (1 - fx) * (1 - fy)
        + coarse_desc[y0, x0 + 1] * fx * (1 - fy)
        + coarse_desc[y0 + 1, x0] * (1 - fx) * fy
        + coarse_desc[y0 + 1, x0 + 1] * fx * fy
    )
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    return Features(kps=torch.stack([xs, ys], dim=-1), desc=desc, valid=valid)


def superpoint_heads(model: nn.Module, imgs: torch.Tensor, compute_dtype=torch.bfloat16):
    """(B, H, W) float images in [0, 1], H and W multiples of 8 ->
    (heat (B, H, W), coarse_desc (B, H/8, W/8, 256)), float32.

    The network runs in `compute_dtype` on the whole batch at once.
    """
    det, desc = model(imgs[:, None].to(compute_dtype))
    det = det.to(torch.float32)
    if isinstance(model, SuperPointDense):
        heat = torch.sigmoid(det)  # dense head: full-resolution logits
    else:
        heat = heatmap_from_logits(det.permute(0, 2, 3, 1))
    return heat, desc.to(torch.float32).permute(0, 2, 3, 1)
