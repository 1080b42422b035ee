"""Chunked sequence runner: extraction batched over a chunk, then the step.

Port of `make_chunked_step_fn`, `make_chunked_pipeline_fn` and
`apply_pose_delta` from visualodometry_tpu/core/runner.py, with both
frontends. `make_chunked_step_fn` steps precomputed features;
`make_chunked_pipeline_fn` extracts them from a chunk of images and steps
them through it. SIFT: the pyramid stage runs once for the whole chunk
(its band matmuls gain a batch axis), detection and description frame by
frame. SuperPoint: the network runs once on the chunk's frames, keypoint
selection frame by frame. The VO step then runs frame by frame, and with
`enable_ba=True` each chunk ends with the windowed BA of ba/inloop.py.
"""

from __future__ import annotations

from typing import Callable

import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core.state import StepOutput, VOState
from visualodometry_tpu_torch.core.step import make_step_fn
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn
from visualodometry_tpu_torch.frontend.superpoint import make_batched_superpoint_extract_fn


def unstack_features(feats):
    """A chunk's features frame by frame: a stacked `Features` (kps (C, N,
    2), desc (C, N, D), valid (C, N)) cut along its leading axis into a
    list; any other iterable of `Features` as it is."""
    if isinstance(feats, Features):
        return [Features(*(x[i] for x in feats)) for i in range(feats.kps.shape[0])]
    return feats


def stack_outputs(outs) -> StepOutput:
    """Per-frame `StepOutput`s stacked along a new leading axis."""
    return StepOutput(*(torch.stack(x) for x in zip(*outs)))


def make_chunked_step_fn(
    cfg: VOConfig, K, device=None, sampler=None, matcher_params=None
) -> Callable:
    """Chunk runner over precomputed features.

    Returns `run_chunk(state, feats) -> (state, outputs)`: `feats` is an
    iterable of `Features` or one stacked along a leading chunk axis, the outputs a
    `StepOutput` stacked over the chunk's frames. The port of the JAX
    runner's `lax.scan` of the step is a loop over the frames. `sampler`
    and `matcher_params` go to `make_step_fn`; `run_chunk.step` is the step.
    """
    step = make_step_fn(cfg, K, device=device, sampler=sampler, matcher_params=matcher_params)

    def run_chunk(state: VOState, feats) -> tuple[VOState, StepOutput]:
        outs = []
        for f in unstack_features(feats):
            state, out = step(state, f)
            outs.append(out)
        return state, stack_outputs(outs)

    run_chunk.step = step
    return run_chunk


def make_chunked_pipeline_fn(
    cfg: VOConfig, K, device=None, pyramid_impl: str = "auto", matcher_params=None,
    enable_ba: bool = False,
) -> Callable:
    """Chunk runner over raw images (C, H, W), uint8 or float in [0, 1].

    Returns `run_chunk(state, imgs) -> (state, outputs)`, where outputs is
    a `StepOutput` whose fields are stacked over the chunk's frames
    (T_wc (C, 4, 4), is_keyframe (C,), did_reset (C,), ...). Runs on
    `device` (CUDA unless "cpu" is asked for). `pyramid_impl` is
    `build_pyramid`'s `impl` argument ("pallas" routes the SIFT pyramid
    through the blur-stack kernel). cfg.extractor_type "sift" or
    "superpoint" picks the frontend; a SuperPoint state is made with
    `init_state(cfg, desc_dim=256)`. `matcher_params` goes to the step's
    attention matcher (`make_step_fn`).

    With `enable_ba=True` the carry is `(state, KFWindow)` (start it with
    `ba.inloop.init_window(cfg)`): each chunk ends with the windowed BA
    (`ba.inloop.make_ba_chunk_fn`, one host read a chunk), and the chunk's
    poses are retro-corrected by its pose delta (`apply_pose_delta`).
    `run_chunk.ba` is that BA function.
    """
    dev = resolve_device(device)
    run_steps = make_chunked_step_fn(cfg, K, device=dev, matcher_params=matcher_params)
    if cfg.extractor_type == "superpoint":
        extract = make_batched_superpoint_extract_fn(cfg, device=dev)
    elif cfg.extractor_type == "sift":
        extract = make_batched_extract_fn(cfg, device=dev, pyramid_impl=pyramid_impl)
    else:
        raise ValueError(f"make_chunked_pipeline_fn: no extractor {cfg.extractor_type!r}")

    if not enable_ba:

        def run_chunk(state: VOState, imgs) -> tuple[VOState, StepOutput]:
            return run_steps(state, extract(torch.as_tensor(imgs).to(dev)))

        run_chunk.extract, run_chunk.step = extract, run_steps.step
        return run_chunk

    from visualodometry_tpu_torch.ba.inloop import make_ba_chunk_fn

    ba_chunk = make_ba_chunk_fn(cfg, K, device=dev)

    def run_chunk_ba(carry, imgs):
        state, win = carry
        feats = extract(torch.as_tensor(imgs).to(dev))
        state, outs = run_steps(state, feats)
        state, win, delta = ba_chunk(state, win, feats, outs)
        return (state, win), apply_pose_delta(outs, delta)

    run_chunk_ba.extract, run_chunk_ba.step, run_chunk_ba.ba = extract, run_steps.step, ba_chunk
    return run_chunk_ba


def apply_pose_delta(outs: StepOutput, delta: torch.Tensor) -> StepOutput:
    """Retro-correct a chunk's emitted poses by the BA pose delta, from the
    chunk's last keyframe on (the frames after it were tracked in its frame
    of reference), or the whole chunk when it pushed no keyframe (every
    frame was then tracked against the window's newest keyframe, from an
    earlier chunk). No host read."""
    is_kf = outs.is_keyframe.to(torch.int32)
    C = is_kf.shape[0]
    idx = torch.arange(C, device=is_kf.device)
    last_kf = torch.where(
        is_kf.any(), C - 1 - torch.argmax(torch.flip(is_kf, dims=[0])), 0
    )
    mask = (idx >= last_kf)[:, None, None]
    return outs._replace(T_wc=torch.where(mask, delta[None] @ outs.T_wc, outs.T_wc))
