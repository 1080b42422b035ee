"""SuperPoint-based frontend: the extractor closures the engine and the
chunked runner use when `cfg.extractor_type == "superpoint"`.

Port of visualodometry_tpu/frontend/superpoint.py. Weights come from, in
order: an explicit Flax-layout pickle (`weights_path`), an explicit torch
SuperPoint checkpoint (`checkpoint_path`), the best bundled checkpoint
(`_default_weights_path`), or a random init seeded with `seed`. The
architecture follows the weights: a tree with a dense scoring head builds
`SuperPointDense` and thresholds at `cfg.superpoint_dense_threshold`, any
other `SuperPointBackbone` at `cfg.superpoint_threshold`.

The batched form runs the network once on the chunk's (B, 1, H, W) frames
(the JAX runner vmaps the per-frame function) and then selects keypoints
frame by frame.
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.nn.functional as F

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.models import convert, weights
from visualodometry_tpu_torch.models.superpoint import (
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


def _default_weights_path() -> Path | None:
    """Best bundled checkpoint: dense head > VO-pair stage > textured >
    synthetic."""
    for name in (
        "superpoint_dense.pkl",
        "superpoint_vo.pkl",
        "superpoint_textured.pkl",
        "superpoint_synthetic.pkl",
    ):
        if weights.bundled(name).exists():
            return weights.bundled(name)
    return None


def load_superpoint(
    checkpoint_path: str | None = None, seed: int = 0, weights_path: str | None = None
):
    """(model, is_dense) from the weight sources in the module's order."""
    if weights_path is None and checkpoint_path is None:
        weights_path = _default_weights_path()
    if weights_path is not None:
        params = weights.load_flax_pickle(weights_path)
        dense = is_dense_params(params)
        model = SuperPointDense() if dense else SuperPointBackbone()
        model.load_state_dict(convert.superpoint_state_dict_from_flax(params))
        return model, dense
    model = SuperPointBackbone()
    if checkpoint_path is not None:
        model.load_state_dict(convert.load_torch_superpoint(checkpoint_path))
    else:
        model.init_random(torch.Generator().manual_seed(seed))
    return model, False


def _to_float_images(imgs: torch.Tensor) -> torch.Tensor:
    if imgs.dtype == torch.uint8:
        return imgs.to(torch.float32) * (1.0 / 255.0)
    return imgs.to(torch.float32)


def make_batched_superpoint_extract_fn(
    cfg: VOConfig,
    checkpoint_path: str | None = None,
    seed: int = 0,
    weights_path: str | None = None,
    device=None,
    compute_dtype=torch.bfloat16,
):
    """Returns `extract_batch(imgs (B, H, W)) -> list of B Features`.

    Images are uint8 or float in [0, 1]; they are padded to multiples of 8.
    The network runs in `compute_dtype` (bf16, as the JAX package runs it;
    float32 for tests), post-processing in float32, on `device` (CUDA
    unless "cpu" is asked for).
    """
    dev = resolve_device(device)
    model, dense = load_superpoint(checkpoint_path, seed, weights_path)
    model = model.to(dev).eval()
    threshold = cfg.superpoint_dense_threshold if dense else cfg.superpoint_threshold

    @torch.no_grad()
    def extract_batch(imgs: torch.Tensor) -> list[Features]:
        x = _pad_to_multiple(_to_float_images(torch.as_tensor(imgs).to(dev)))
        heat, desc = superpoint_heads(model, x, compute_dtype)
        return [
            select_keypoints(
                heat[i], desc[i], cfg.padded_keypoints, threshold,
                img=x[i] if cfg.superpoint_forstner else None,
            )
            for i in range(x.shape[0])
        ]

    extract_batch.model, extract_batch.threshold = model, threshold
    return extract_batch


def make_superpoint_extract_fn(
    cfg: VOConfig,
    checkpoint_path: str | None = None,
    seed: int = 0,
    weights_path: str | None = None,
    device=None,
    compute_dtype=torch.bfloat16,
):
    """Returns `extract(img (H, W)) -> Features`, uint8 or float in [0, 1]."""
    batch = make_batched_superpoint_extract_fn(
        cfg, checkpoint_path, seed, weights_path, device, compute_dtype
    )

    def extract(img: torch.Tensor) -> Features:
        return batch(torch.as_tensor(img)[None])[0]

    extract.model = batch.model
    return extract


def make_superpoint_extractor(
    cfg: VOConfig, checkpoint_path: str | None = None, seed: int = 0, device=None
):
    """Returns `extract(img (H, W)) -> Features` (the JAX package's jitted
    form; the port runs eagerly)."""
    return make_superpoint_extract_fn(cfg, checkpoint_path, seed, device=device)
