"""Per-keypoint window gather: CUDA kernel K2 and its plain version.

Counterpart of visualodometry_tpu/ops/patches.py. `extract_patches` runs
the hand-written kernel (csrc/patches.cu) for CUDA tensors and the plain
PyTorch version `_extract_patches_torch` for CPU tensors.

The Mosaic-only constraints of the TPU kernel (y0 % 8, W % 128, K % 8, the
128-lane over-fetch) are not requirements here: any in-bounds origin is
taken, and an out-of-bounds one raises.
"""

from __future__ import annotations

import ctypes

import torch

from visualodometry_tpu_torch.ops import _build

# kernel launches since the last reset (a plain count; callers zero it)
launches = 0


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


def extract_patches(
    field: torch.Tensor,
    lvl: torch.Tensor,
    y0: torch.Tensor,
    x0: torch.Tensor,
    patch_y: int,
    patch_x: int,
    check_bounds: bool = True,
) -> torch.Tensor:
    """Gather K windows field[lvl[k], y0[k]:y0[k]+Py, x0[k]:x0[k]+Px].

    field: (L, H, W) int32; lvl/y0/x0: (K,) int32. Returns (K, Py, Px)
    int32. Raises if an origin puts a window outside the field; the check
    reads one flag back from the device (one synchronisation per call),
    which `check_bounds=False` skips for callers whose origins are
    in-bounds by construction.
    """
    global launches
    if field.dtype != torch.int32 or field.dim() != 3:
        raise TypeError("extract_patches: field must be (L, H, W) int32")
    K = lvl.shape[0]
    for name, t in (("lvl", lvl), ("y0", y0), ("x0", x0)):
        if t.dtype != torch.int32 or t.shape != (K,):
            raise TypeError(f"extract_patches: {name} must be (K,) int32")
        if t.device != field.device:
            raise ValueError("extract_patches: inputs on different devices")
    L, H, W = field.shape
    if patch_y > H or patch_x > W:
        raise ValueError(f"extract_patches: window {patch_y}x{patch_x} > field {H}x{W}")
    if check_bounds and _origins_out_of_bounds(field, lvl, y0, x0, patch_y, patch_x):
        raise IndexError("extract_patches: window origin out of bounds")
    if field.device.type == "cpu":
        return _extract_patches_torch(field, lvl, y0, x0, patch_y, patch_x)
    if field.device.type != "cuda":
        raise ValueError(f"extract_patches: unsupported device {field.device}")
    if not field.is_contiguous():
        raise ValueError("extract_patches: field must be contiguous")
    # bound to names so no temporary is freed (and its memory reused)
    # before the launch reads it
    lvl, y0, x0 = lvl.contiguous(), y0.contiguous(), x0.contiguous()
    out = torch.empty((K, patch_y, patch_x), dtype=torch.int32, device=field.device)
    lib = _build.load_library("patches")
    fn = lib.patches_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    err = fn(
        field.data_ptr(), lvl.data_ptr(), y0.data_ptr(), x0.data_ptr(),
        out.data_ptr(), K, L, H, W, patch_y, patch_x,
        _build.current_stream_handle(field.device),
    )
    _build.check_launch("extract_patches", err)
    launches += 1
    return out
