"""Pyramidal Lucas-Kanade (KLT) tracking, batched over keypoints.

Port of visualodometry_tpu/ops/klt.py. Coarse-to-fine translation per
keypoint with a fixed iteration count per level; the 2x2 normal systems
are solved in closed form. Two ways to sample the image, as in the JAX
package:

- "gather": every LK tap is a bilinear sample by advanced indexing;
- "patch": one window per keypoint per level comes from K2
  (`ops/patches.extract_patches`, csrc/patches.cu on CUDA), and every tap
  after that is a separable contraction of bilinear "hats" over the
  window: the tap grid is axis-aligned and shifts uniformly with the flow,
  and a product of two linear hats is bilinear interpolation.

`sampling="auto"` means "patch" for CUDA tensors and "gather" for CPU
tensors, as the JAX function picks "patch" on the TPU and "gather" on the
CPU. On the CPU, "patch" runs K2's plain version, which is what the JAX
function's "patch_interpret" is to its kernel.

The patch path gates in-level refinement beyond `drift - 1` = 5 px (the
next-frame window holds +-6 px): at larger flows per level it rejects
tracks the gather path keeps. That difference is the JAX package's too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from visualodometry_tpu_torch.ops.patches import extract_patches
from visualodometry_tpu_torch.ops.pyramid import blur_2d, downsample_2x

# in-level refinement budget inside the next-frame window (px)
DRIFT = 6


def build_klt_pyramid(img: torch.Tensor, num_levels: int) -> list[torch.Tensor]:
    """Standard tracking pyramid: blur + 2x downsample per level."""
    levels = [img]
    for _ in range(num_levels - 1):
        levels.append(downsample_2x(blur_2d(levels[-1], 1.0)))
    return levels


def _patch_offsets(radius: int, device):
    lin = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(lin, lin, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)  # (P,)


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    i = y0.long() * W + x0.long()
    flat = img.reshape(-1)
    v00 = flat[i]
    v01 = flat[i + 1]
    v10 = flat[i + W]
    v11 = flat[i + W + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _solve_2x2(gxx, gxy, gyy, bx, by, det_safe, invertible):
    """The LK step: solve [gxx gxy; gxy gyy] d = -b, 0 where singular."""
    dx = -(gyy * bx - gxy * by) / det_safe
    dy = -(gxx * by - gxy * bx) / det_safe
    return torch.where(invertible[:, None], torch.stack([dx, dy], -1), 0.0)


def _track_level(prev, nxt, pts_prev, flow, radius: int, iters: int):
    """Refine per-keypoint translation at one pyramid level (gather)."""
    dx_off, dy_off = _patch_offsets(radius, prev.device)
    px = pts_prev[:, 0:1] + dx_off[None, :]  # (N, P)
    py = pts_prev[:, 1:2] + dy_off[None, :]

    # template and gradients from the previous frame, fixed per level
    t = _bilinear(prev, px, py)
    gx = 0.5 * (_bilinear(prev, px + 1, py) - _bilinear(prev, px - 1, py))
    gy = 0.5 * (_bilinear(prev, px, py + 1) - _bilinear(prev, px, py - 1))

    gxx = torch.sum(gx * gx, dim=1)
    gxy = torch.sum(gx * gy, dim=1)
    gyy = torch.sum(gy * gy, dim=1)
    det = gxx * gyy - gxy * gxy
    invertible = det > 1e-6
    det_safe = torch.where(invertible, det, 1.0)

    for _ in range(iters):
        e = _bilinear(nxt, px + flow[:, 0:1], py + flow[:, 1:2]) - t  # (N, P)
        bx = torch.sum(gx * e, dim=1)
        by = torch.sum(gy * e, dim=1)
        flow = flow + _solve_2x2(gxx, gxy, gyy, bx, by, det_safe, invertible)
    return flow, invertible


# --------------------------------------------------------------------------
# Patch sampling path (K2)


def _patch_field(img: torch.Tensor) -> torch.Tensor:
    """(H, W) float32 -> (1, H8, W128) int32 bitcast field for K2.

    Rows padded to a multiple of 8 and columns to a multiple of 128 (at
    least 256) by edge replication, as the JAX function pads for its
    kernel: K2 does not need it, but the clip ranges of the window origins,
    and so the sampled values, depend on the padded extent.
    """
    H, W = img.shape
    H8 = -(-H // 8) * 8
    W128 = max(-(-W // 128) * 128, 256)
    padded = F.pad(img[None, None], (0, W128 - W, 0, H8 - H), mode="replicate")[0, 0]
    return padded.contiguous().view(torch.int32)[None]


def _hats(u: torch.Tensor, n: int) -> torch.Tensor:
    """(N, T) window-coordinate taps -> (N, T, n) bilinear hat weights."""
    u = torch.clamp(u, 0.0, n - 1.001)
    iota = torch.arange(n, dtype=torch.float32, device=u.device)
    return torch.clamp(1.0 - torch.abs(u[..., None] - iota), min=0.0)


def _sample_sep(patches: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """Separable bilinear sampling: (N, Py, Px) x (N, Tx) x (N, Ty)
    -> (N, Ty, Tx) values at every (uy, ux) grid point."""
    rows = torch.bmm(_hats(uy, patches.shape[1]), patches)  # (N, Ty, Px)
    return torch.bmm(rows, _hats(ux, patches.shape[2]).transpose(1, 2))


def _sample_sep_shared(img: torch.Tensor, ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """`_sample_sep` against one shared (H, W) image, for levels smaller
    than a window: the row contraction runs against the level itself."""
    rows = _hats(uy, img.shape[0]) @ img  # (N, Ty, W)
    return torch.bmm(rows, _hats(ux, img.shape[1]).transpose(1, 2))


def window_origins(field, x, y, r, py_w, px_w):
    """K2's (lvl, y0, x0) for a py_w x px_w window per keypoint at (x, y):
    floor(x) - r, floor(y) - r with the row rounded down to a multiple of
    8 (the JAX kernel's row alignment, kept because it sets which rows a
    window holds), clipped into the field, so in bounds by construction."""
    _, Hf, Wp = field.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int32) - r, 0, Wp - px_w)
    y0 = torch.clamp(
        torch.bitwise_and(torch.floor(y).to(torch.int32) - r, ~7), 0, Hf - py_w
    )
    return torch.zeros_like(x0), y0, x0


def _window_sampler(field, x, y, r, px_w):
    """A sampler over one K2 window of (px_w + 8) x px_w per keypoint
    around (x, y) (`window_origins`), or over the whole level when the
    level is smaller than a window. K2 runs without its bounds check,
    which would read a flag back."""
    py_w = px_w + 8
    if field.shape[1] < py_w:
        img = field[0].view(torch.float32)
        return lambda ax, ay: _sample_sep_shared(img, ax, ay)
    lvl, y0, x0 = window_origins(field, x, y, r, py_w, px_w)
    win = extract_patches(field, lvl, y0, x0, py_w, px_w, check_bounds=False)
    win = win.view(torch.float32)
    fx0 = x0[:, None].to(torch.float32)
    fy0 = y0[:, None].to(torch.float32)
    return lambda ax, ay: _sample_sep(win, ax - fx0, ay - fy0)


def _track_level_patch(field_prev, field_next, H, W, pts_prev, flow, radius: int,
                       iters: int, drift: int):
    """One pyramid level of LK on K2 windows.

    field_*: (1, H8, W128) int32 fields of this level. drift: the largest
    flow change inside the level that the next-frame window accommodates.
    Returns (flow, ok, (sample_next, t)): the next-frame sampler and the
    (N, T, T) template, which the caller reuses for the final residual at
    level 0.
    """
    x, y = pts_prev[:, 0], pts_prev[:, 1]
    r1 = radius + 2  # template tap span: +-(radius+1) taps, +1 bilinear
    PxT = -(-(2 * r1 + 1) // 8) * 8  # 16 at radius 4
    sample_prev = _window_sampler(field_prev, x, y, r1, PxT)

    lin = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)

    # clip taps to the true image extent first (the gather path's edge
    # clamp), then rebase into the window
    def cx(v):
        return torch.clamp(v, 0.0, W - 1.001)

    def cy(v):
        return torch.clamp(v, 0.0, H - 1.001)

    ax = cx(x[:, None] + lin)
    ay = cy(y[:, None] + lin)
    t = sample_prev(ax, ay)  # (N, T, T)
    gx = 0.5 * (sample_prev(cx(ax + 1), ay) - sample_prev(cx(ax - 1), ay))
    gy = 0.5 * (sample_prev(ax, cy(ay + 1)) - sample_prev(ax, cy(ay - 1)))

    gxx = torch.sum(gx * gx, dim=(1, 2))
    gxy = torch.sum(gx * gy, dim=(1, 2))
    gyy = torch.sum(gy * gy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    invertible = det > 1e-6
    det_safe = torch.where(invertible, det, 1.0)

    # next-frame window around the predicted position, wide enough for
    # +-drift of in-level refinement
    rN = radius + drift + 2
    PxN = -(-(2 * rN + 1) // 8) * 8  # 32 at radius 4, drift 6
    sample_next = _window_sampler(field_next, x + flow[:, 0], y + flow[:, 1], rN, PxN)

    flow0 = flow
    for _ in range(iters):
        aqx = cx(x[:, None] + lin + flow[:, 0:1])
        aqy = cy(y[:, None] + lin + flow[:, 1:2])
        e = sample_next(aqx, aqy) - t
        bx = torch.sum(gx * e, dim=(1, 2))
        by = torch.sum(gy * e, dim=(1, 2))
        flow = flow + _solve_2x2(gxx, gxy, gyy, bx, by, det_safe, invertible)
    # refinement that left the window's drift budget is untrusted
    ok = invertible & (torch.amax(torch.abs(flow - flow0), dim=1) <= drift - 1.0)
    return flow, ok, (sample_next, t)


def _in_bounds(new_kps, H, W, radius):
    return (
        (new_kps[:, 0] >= radius) & (new_kps[:, 0] < W - radius)
        & (new_kps[:, 1] >= radius) & (new_kps[:, 1] < H - radius)
    )


def klt_track(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    kps: torch.Tensor,
    valid: torch.Tensor,
    num_levels: int = 3,
    radius: int = 4,
    iters: int = 10,
    max_residual: float = 0.04,
    sampling: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track (N, 2) keypoints from img_prev to img_next ((H, W) float32 in
    [0, 1], on one device).

    Returns (new_kps (N, 2), tracked (N,) bool). `tracked` requires an
    invertible structure tensor at every level, an in-bounds result, and a
    mean absolute window residual below `max_residual`. `sampling`:
    "gather", "patch" (K2), or "auto" ("patch" on CUDA, "gather" on the
    CPU). No host synchronisation on either path.
    """
    if sampling == "auto":
        sampling = "patch" if img_prev.device.type == "cuda" else "gather"
    if sampling == "patch":
        return _klt_track_patch(
            img_prev, img_next, kps, valid, num_levels, radius, iters, max_residual
        )
    if sampling != "gather":
        raise ValueError(f"klt_track: unknown sampling {sampling!r}")
    pyr_prev = build_klt_pyramid(img_prev, num_levels)
    pyr_next = build_klt_pyramid(img_next, num_levels)

    flow = torch.zeros_like(kps)
    ok = valid
    for lvl in range(num_levels - 1, -1, -1):
        s = 2.0**lvl
        flow, invertible = _track_level(
            pyr_prev[lvl], pyr_next[lvl], kps / s, flow / s, radius, iters
        )
        ok = ok & invertible
        flow = flow * s

    new_kps = kps + flow

    # final verification at full resolution
    dx_off, dy_off = _patch_offsets(radius, kps.device)
    t = _bilinear(pyr_prev[0], kps[:, 0:1] + dx_off, kps[:, 1:2] + dy_off)
    q = _bilinear(pyr_next[0], new_kps[:, 0:1] + dx_off, new_kps[:, 1:2] + dy_off)
    residual = torch.mean(torch.abs(q - t), dim=1)
    H, W = img_prev.shape
    tracked = ok & _in_bounds(new_kps, H, W, radius) & (residual < max_residual)
    return new_kps, tracked


def _klt_track_patch(img_prev, img_next, kps, valid, num_levels, radius, iters,
                     max_residual):
    """klt_track on the K2 path (see klt_track)."""
    # pad the slot count to a multiple of 8 with idle slots, as the JAX
    # function does for its kernel's groups of 8
    n_in = kps.shape[0]
    n_pad = (-n_in) % 8
    if n_pad:
        kps = torch.cat([kps, kps.new_full((n_pad, 2), 16.0)])
        valid = torch.cat([valid, valid.new_zeros((n_pad,))])
    pyr_prev = build_klt_pyramid(img_prev, num_levels)
    pyr_next = build_klt_pyramid(img_next, num_levels)

    flow = torch.zeros_like(kps)
    ok = valid
    extras = None
    for lvl in range(num_levels - 1, -1, -1):
        s = 2.0**lvl
        Hl, Wl = pyr_prev[lvl].shape
        flow, lvl_ok, extras = _track_level_patch(
            _patch_field(pyr_prev[lvl]), _patch_field(pyr_next[lvl]), Hl, Wl,
            kps / s, flow / s, radius, iters, DRIFT,
        )
        ok = ok & lvl_ok
        flow = flow * s

    new_kps = kps + flow

    # final verification at full resolution, on the level-0 template and
    # next-frame window (the drift gate in `ok` keeps trusted flows inside)
    sample_next, t = extras
    H, W = img_prev.shape
    lin = torch.arange(-radius, radius + 1, dtype=torch.float32, device=kps.device)
    aqx = torch.clamp(new_kps[:, 0:1] + lin, 0.0, W - 1.001)
    aqy = torch.clamp(new_kps[:, 1:2] + lin, 0.0, H - 1.001)
    residual = torch.mean(torch.abs(sample_next(aqx, aqy) - t), dim=(1, 2))
    tracked = ok & _in_bounds(new_kps, H, W, radius) & (residual < max_residual)
    return new_kps[:n_in], tracked[:n_in]
