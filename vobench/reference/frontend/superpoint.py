"""SuperPoint frontend (frozen copy): network heads, then keypoint selection.

Copied from visualodometry_tpu_torch/frontend/superpoint.py, for weights
from a Flax-layout pickle only (the bundled `superpoint_dense.pkl` is the
configuration's). The network runs once on a batch of frames, then
keypoints are selected frame by frame. `make_batched_superpoint_extract_fn`
also exposes the network's outputs (`extract_batch.heads`), which the
correctness check compares.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vobench.reference._device import resolve_device
from vobench.reference.config import VOConfig
from vobench.reference.frontend.interface import Features
from vobench.reference.models import convert, weights
from vobench.reference.models.superpoint import (
    SuperPointBackbone,
    SuperPointDense,
    is_dense_params,
    select_keypoints,
    superpoint_heads,
)


def _pad_to_multiple(img: torch.Tensor, m: int = 8) -> torch.Tensor:
    """Zero-pad the last two dims at the bottom and right to multiples of m."""
    h, w = img.shape[-2:]
    ph, pw = (-h) % m, (-w) % m
    if ph or pw:
        img = F.pad(img, (0, pw, 0, ph))
    return img


def load_superpoint(weights_path):
    """(model, is_dense) from a Flax-layout weight file."""
    params = weights.load_flax_pickle(weights_path)
    dense = is_dense_params(params)
    model = SuperPointDense() if dense else SuperPointBackbone()
    model.load_state_dict(convert.superpoint_state_dict_from_flax(params))
    return model, dense


def _to_float_images(imgs: torch.Tensor) -> torch.Tensor:
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) * (1.0 / 255.0)
    return imgs.to(torch.float32)


def make_batched_superpoint_extract_fn(
    cfg: VOConfig, weights_path, device=None, compute_dtype=torch.bfloat16
):
    """Returns `extract_batch(imgs (B, H, W)) -> list of B Features`.

    `extract_batch.heads(imgs)` gives the network's outputs, (heat (B, H,
    W), coarse_desc (B, H/8, W/8, 256)) in float32, on the padded frames.
    """
    dev = resolve_device(device)
    model, dense = load_superpoint(weights_path)
    model = model.to(dev).eval()
    threshold = cfg.superpoint_dense_threshold if dense else cfg.superpoint_threshold

    @torch.no_grad()
    def heads(imgs):
        x = _pad_to_multiple(_to_float_images(torch.as_tensor(imgs).to(dev)))
        return x, superpoint_heads(model, x, compute_dtype)

    @torch.no_grad()
    def extract_batch(imgs: torch.Tensor) -> list[Features]:
        x, (heat, desc) = heads(imgs)
        return [
            select_keypoints(
                heat[i], desc[i], cfg.padded_keypoints, threshold,
                img=x[i] if cfg.superpoint_forstner else None,
            )
            for i in range(x.shape[0])
        ]

    extract_batch.heads = lambda imgs: heads(imgs)[1]
    extract_batch.model, extract_batch.threshold = model, threshold
    return extract_batch
