"""NMS-aware training for the dense scoring head (SuperPointDense).

Port of visualodometry_tpu/models/train_superpoint_dense.py. The dense head
is trained so that the inference-time selection (NMS over the full-res
score map, then the 3x3 probability-centroid refinement of
`superpoint.select_keypoints`) lands on the SIFT teacher's positions:

1. balanced detection BCE on the score logits: positives at the teacher
   keypoints' rounded pixels, negatives outside a 2-px ignore ring around
   them;
2. localization: the inference refinement (3x3 sigmoid-prob centroid
   around the rounded teacher pixel) regressed onto the teacher's subpixel
   offset (Huber, delta 0.25);
3. descriptor InfoNCE over the cell correspondences (`info_nce_sym`).

Teacher pool and batches come from vo_distill.py.

Operators against the JAX module's: the scatter-max of the positives is
`scatter_reduce_(..., "amax")` (a pixel hit by a valid and an invalid
keypoint keeps 1 whatever the order); the 5x5 zero-padded window max is
`max_pool2d` (its -inf padding gives the same result since every window
holds its centre and the target is >= 0); `optax.sigmoid_binary_cross_entropy`
is `binary_cross_entropy_with_logits`; `optax.huber_loss` is `huber_loss`.
Rounded positions carry no gradient, as `jnp.round` gives none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.models import convert
from visualodometry_tpu_torch.models.optim import Adam
from visualodometry_tpu_torch.models.superpoint import SuperPointDense
from visualodometry_tpu_torch.models.train_superpoint import forward_pair, make_step
from visualodometry_tpu_torch.models.train_superpoint_textured import info_nce_sym
from visualodometry_tpu_torch.models.vo_distill import (
    TrainBatchSub,
    homography_pool_batch,
    vo_pair_batch,
)


def _positions_from_labels(labels: torch.Tensor, sub: torch.Tensor):
    """Cell labels + in-cell subpixel -> full-res teacher positions.

    labels: (B, Hc, Wc) int in [0, 64] (64 = dustbin); sub: (B, Hc, Wc, 2)
    (x, y) in-cell in [0, 8), zeros where there is no subpixel target (the
    integer cell-class position is used then). Returns pos (B, Hc*Wc, 2)
    float32 (x, y) and valid (B, Hc*Wc).
    """
    B, Hc, Wc = labels.shape
    dev = labels.device
    valid = labels != 64
    lx = (labels % 8).to(torch.float32)
    ly = torch.div(labels, 8, rounding_mode="floor").to(torch.float32)
    cj = torch.arange(Wc, dtype=torch.float32, device=dev)[None, None, :]
    ci = torch.arange(Hc, dtype=torch.float32, device=dev)[None, :, None]
    has_sub = torch.any(sub != 0.0, dim=-1)
    px = torch.where(has_sub, sub[..., 0], lx) + cj * 8.0
    py = torch.where(has_sub, sub[..., 1], ly) + ci * 8.0
    pos = torch.stack([px, py], dim=-1).reshape(B, Hc * Wc, 2)
    return pos, valid.reshape(B, Hc * Wc)


def _rounded(pos: torch.Tensor, lo: int, hi_x: int, hi_y: int):
    xi = torch.clamp(torch.round(pos[..., 0]).long(), lo, hi_x)
    yi = torch.clamp(torch.round(pos[..., 1]).long(), lo, hi_y)
    return xi, yi


def _detection_bce(score: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor):
    """Balanced BCE with a dilated ignore ring around positives.

    score: (B, H, W) logits; pos: (B, N, 2) float (x, y); valid: (B, N).
    """
    B, H, W = score.shape
    xi, yi = _rounded(pos, 0, W - 1, H - 1)
    bidx = torch.arange(B, device=score.device)[:, None].expand_as(xi)
    tgt = torch.zeros(B * H * W, dtype=torch.float32, device=score.device)
    flat = ((bidx * H + yi) * W + xi).reshape(-1)
    tgt.scatter_reduce_(0, flat, valid.to(torch.float32).reshape(-1), reduce="amax")
    tgt = tgt.reshape(B, H, W)
    # ignore ring: within 2 px of a positive but not on it
    dil = F.max_pool2d(tgt[:, None], 5, 1, 2)[:, 0]
    neg_mask = dil == 0.0
    pos_mask = tgt == 1.0
    bce = F.binary_cross_entropy_with_logits(score, tgt, reduction="none")
    l_pos = torch.sum(torch.where(pos_mask, bce, 0.0)) / torch.clamp(pos_mask.sum(), min=1)
    l_neg = torch.sum(torch.where(neg_mask, bce, 0.0)) / torch.clamp(neg_mask.sum(), min=1)
    return l_pos + l_neg


def _localization_loss(score: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor):
    """Huber between the 3x3 sigmoid-prob centroid and the teacher offset,
    the window centred on the rounded teacher pixel."""
    B, H, W = score.shape
    prob = torch.sigmoid(score)
    x0, y0 = _rounded(pos, 1, W - 2, H - 2)
    bidx = torch.arange(B, device=score.device)[:, None].expand_as(x0)
    wsum = torch.zeros(x0.shape, dtype=torch.float32, device=score.device)
    ox = torch.zeros_like(wsum)
    oy = torch.zeros_like(wsum)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            w = prob[bidx, y0 + di, x0 + dj]
            wsum = wsum + w
            oy = oy + w * di
            ox = ox + w * dj
    wsum = torch.clamp(wsum, min=1e-6)
    pred = torch.stack([ox, oy], -1) / wsum[..., None]
    tgt = pos - torch.stack([x0, y0], -1).to(torch.float32)
    err = F.huber_loss(pred, torch.clamp(tgt, -0.5, 0.5), reduction="none", delta=0.25)
    m = valid[..., None]
    return torch.sum(torch.where(m, err, 0.0)) / torch.clamp(m.sum(), min=1)


def loss_fn_dense(model: SuperPointDense, batch: TrainBatchSub, desc_w: float = 2.0,
                  loc_w: float = 4.0):
    """(total, (det_loss, loc_loss, desc_loss))."""
    h = batch.h
    score0, desc0, score1, desc1 = forward_pair(model, h.img0, h.img1)
    B = score0.shape[0]
    pos0, v0 = _positions_from_labels(h.labels0, batch.sub0)
    v0 = v0 & batch.subv0.reshape(B, -1)
    pos1, v1 = _positions_from_labels(h.labels1, torch.zeros_like(batch.sub0))
    det_loss = 0.5 * (_detection_bce(score0, pos0, v0) + _detection_bce(score1, pos1, v1))
    loc_loss = _localization_loss(score0, pos0, v0)
    desc_loss = info_nce_sym(desc0, desc1, h.cell_tgt, h.cell_valid)
    total = det_loss + loc_w * loc_loss + desc_w * desc_loss
    return total, (det_loss, loc_loss, desc_loss)


def warm_start_dense(generator: torch.Generator, backbone_params: dict, input_hw=(320, 640),
                     device=None) -> SuperPointDense:
    """A `SuperPointDense` with its shared layers from a backbone checkpoint.

    `backbone_params` is a `SuperPointBackbone` Flax tree (a bundled weight
    file, or `save_params`'s). conv1a..conv4b and convDa/convDb are copied;
    the score head keeps its fresh init (LeCun-normal from `generator`,
    zero biases). `input_hw` is the JAX function's; the parameters do not
    depend on it. On `device` (CUDA unless "cpu" is asked for).
    """
    del input_hw
    model = SuperPointDense()
    model.init_random(generator)
    src = convert.superpoint_state_dict_from_flax(backbone_params)
    own = model.state_dict()
    shared = {k: v for k, v in src.items() if k in own and not k.startswith("convP")}
    model.load_state_dict(shared, strict=False)
    return model.to(resolve_device(device))


def make_train_step_dense(model: SuperPointDense, optimizer: Adam, desc_w: float = 2.0,
                          loc_w: float = 4.0, group=None):
    return make_step(model, optimizer, lambda m, b: loss_fn_dense(m, b, desc_w, loc_w), group)


def recipe_batch(rng, pool: dict, i: int, steps: int, batch: int = 8, hw=(320, 640)):
    """Batch i of the recipe that trained the bundled `superpoint_dense.pkl`
    (scripts/train_superpoint_dense.py): VO pairs on even steps,
    homography pairs on odd ones, the warp strength rising from 0.04 to 0.12
    over the first 40% of the steps."""
    if i % 2 == 0:
        return vo_pair_batch(rng, pool, batch=batch, hw=hw)
    strength = 0.04 + 0.08 * min(i / (0.4 * steps), 1.0)
    return homography_pool_batch(rng, pool, batch=batch, hw=hw, strength=strength)
