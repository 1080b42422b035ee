"""Per-keypoint window gather, plain: the reference for kernel K2.

Frozen copy of the plain version of visualodometry_tpu_torch/ops/
patches.py (`_extract_patches_torch`): flat indices into the field, one
gather, on whatever device the tensors are on. No kernel.
"""

from __future__ import annotations

import torch


def _extract_patches_torch(field, lvl, y0, x0, patch_y: int, patch_x: int):
    """Plain version: flat indices into the field, one gather."""
    L, H, W = field.shape
    iy = torch.arange(patch_y, device=field.device)
    ix = torch.arange(patch_x, device=field.device)
    rows = (lvl.long() * H + y0.long())[:, None] + iy[None, :]  # (K, Py)
    flat = (rows * W)[:, :, None] + (x0.long()[:, None, None] + ix[None, None, :])
    return field.reshape(-1)[flat]


def _origins_out_of_bounds(field, lvl, y0, x0, patch_y, patch_x) -> bool:
    L, H, W = field.shape
    bad = (
        (lvl < 0) | (lvl >= L) | (y0 < 0) | (y0 > H - patch_y)
        | (x0 < 0) | (x0 > W - patch_x)
    )
    return bool(bad.any())


def extract_patches(field, lvl, y0, x0, patch_y: int, patch_x: int, check_bounds: bool = True):
    """K windows field[lvl[k], y0[k]:y0[k]+Py, x0[k]:x0[k]+Px] -> (K, Py, Px)."""
    if check_bounds and _origins_out_of_bounds(field, lvl, y0, x0, patch_y, patch_x):
        raise IndexError("extract_patches: window origin out of bounds")
    return _extract_patches_torch(field, lvl, y0, x0, patch_y, patch_x)
