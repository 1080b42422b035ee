"""Chunked sequence runner: extraction batched over a chunk, then the step.

Port of `make_chunked_pipeline_fn` (SIFT branch, without BA) from
visualodometry_tpu/core/runner.py. The pyramid stage runs once for the
whole chunk (its band matmuls gain a batch axis); detection, description
and the VO step then run frame by frame.
"""

from __future__ import annotations

from typing import Callable

import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core.state import StepOutput, VOState
from visualodometry_tpu_torch.core.step import make_step_fn
from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn


def make_chunked_pipeline_fn(
    cfg: VOConfig, K, device=None, pyramid_impl: str = "auto"
) -> Callable:
    """Chunk runner over raw images (C, H, W), uint8 or float in [0, 1].

    Returns `run_chunk(state, imgs) -> (state, outputs)`, where outputs is
    a `StepOutput` whose fields are stacked over the chunk's frames
    (T_wc (C, 4, 4), is_keyframe (C,), did_reset (C,), ...). Runs on
    `device` (CUDA unless "cpu" is asked for). `pyramid_impl` is
    `build_pyramid`'s `impl` argument ("pallas" routes the pyramid through
    the blur-stack kernel).
    """
    if cfg.extractor_type != "sift":
        raise NotImplementedError("make_chunked_pipeline_fn: only SIFT is ported")
    dev = resolve_device(device)
    step = make_step_fn(cfg, K, device=dev)
    extract = make_batched_extract_fn(cfg, device=dev, pyramid_impl=pyramid_impl)

    def run_chunk(state: VOState, imgs) -> tuple[VOState, StepOutput]:
        feats = extract(torch.as_tensor(imgs).to(dev))
        outs = []
        for f in feats:
            state, out = step(state, f)
            outs.append(out)
        return state, StepOutput(*(torch.stack(x) for x in zip(*outs)))

    return run_chunk
