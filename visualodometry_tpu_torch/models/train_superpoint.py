"""Synthetic pretraining for SuperPoint (MagicPoint recipe), and the train step.

Port of visualodometry_tpu/models/train_superpoint.py:

- detector head: per-8x8-cell 65-way cross entropy (64 positions +
  dustbin) against rendered blob ground truth;
- descriptor head: InfoNCE between cell descriptors of two views related
  by a known integer shift (positives = corresponding cells).

`make_train_step` is the step every SuperPoint trainer of the port runs:
the loss and its gradient by autograd, with a process group the gradients
and the loss all-reduced to their mean (the JAX step's `lax.pmean` over
`axis_name`, as `__graft_entry__.dryrun_multichip` runs it over the mesh's
"seq" axis), then one Adam update (models/optim.py). All gradients travel
in one flat buffer: one all-reduce a step.

Batches are numpy on the host, made from a `np.random.Generator` exactly as
the JAX generators make them (the same seed gives the same arrays), and
handed over as CPU tensors; the step moves them to the model's device.
"""

from __future__ import annotations

import pickle
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn as nn

from visualodometry_tpu_torch.models import convert, weights
from visualodometry_tpu_torch.models.optim import Adam
from visualodometry_tpu_torch.models.superpoint import SuperPointBackbone


class TrainBatch(NamedTuple):
    img0: torch.Tensor  # (B, H, W) float32
    img1: torch.Tensor  # (B, H, W) shifted view
    labels0: torch.Tensor  # (B, Hc, Wc) int32 cell class in [0, 64]
    shift: torch.Tensor  # (B, 2) int32 (dx, dy) of view 1 vs view 0


def batch_to(batch, device: torch.device):
    """A batch NamedTuple (nested ones too) with every tensor on `device`."""
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return type(batch)(*(batch_to(x, device) for x in batch))


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def synthetic_batch(
    rng: np.random.Generator,
    batch: int = 16,
    hw: tuple[int, int] = (96, 128),
    n_points: int = 24,
    max_shift: int = 24,
) -> TrainBatch:
    """Random blob images with known keypoints + shifted second views."""
    H, W = hw
    hc, wc = H // 8, W // 8
    labels = np.full((batch, hc, wc), 64, np.int32)  # dustbin default
    shifts = rng.integers(-max_shift, max_shift + 1, (batch, 2)).astype(np.int32)
    margin = max_shift + 6
    px = rng.uniform(margin, W - margin, (batch, n_points)).astype(np.float32)
    py = rng.uniform(margin, H - margin, (batch, n_points)).astype(np.float32)
    sig = rng.uniform(1.0, 2.2, (batch, n_points)).astype(np.float32)
    amp = rng.uniform(0.4, 1.0, (batch, n_points)).astype(np.float32)

    yy = np.arange(H, dtype=np.float32)[None, None, :, None]
    xx = np.arange(W, dtype=np.float32)[None, None, None, :]

    def render(cx, cy):
        # (B, P, H, W) blob field -> max over P
        d2 = (xx - cx[:, :, None, None]) ** 2 + (yy - cy[:, :, None, None]) ** 2
        return (amp[:, :, None, None] * np.exp(-d2 / (2 * sig[:, :, None, None] ** 2))).max(
            axis=1
        )

    imgs0 = render(px, py)
    imgs1 = render(
        px + shifts[:, 0:1].astype(np.float32),
        py + shifts[:, 1:2].astype(np.float32),
    )
    imgs0 = np.clip(imgs0 + rng.normal(0, 0.02, imgs0.shape), 0, 1).astype(np.float32)
    imgs1 = np.clip(imgs1 + rng.normal(0, 0.02, imgs1.shape), 0, 1).astype(np.float32)

    cxi = np.clip(np.round(px).astype(np.int64), 0, W - 1)
    cyi = np.clip(np.round(py).astype(np.int64), 0, H - 1)
    bidx = np.repeat(np.arange(batch), n_points)
    labels[bidx, cyi.ravel() // 8, cxi.ravel() // 8] = (cyi.ravel() % 8) * 8 + cxi.ravel() % 8
    return TrainBatch(*_tensors(imgs0, imgs1, labels, shifts))


def forward_pair(model: nn.Module, img0: torch.Tensor, img1: torch.Tensor):
    """Both views through the network in one batch of 2B images:
    (head0, desc0, head1, desc1), the detector heads as the model gives
    them and the descriptors NHWC, (B, Hc, Wc, 256)."""
    B = img0.shape[0]
    head, desc = model(torch.cat([img0, img1])[:, None])
    desc = desc.permute(0, 2, 3, 1)
    return head[:B], desc[:B], head[B:], desc[B:]


def cell_ce(det: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean 65-way cross entropy of (B, 65, Hc, Wc) logits on (B, Hc, Wc)
    labels (the JAX one-hot sum picks the same term)."""
    logp = torch.log_softmax(det, dim=1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def loss_fn(model: SuperPointBackbone, batch: TrainBatch, desc_w: float = 1.0):
    """(total, (det_loss, desc_loss)) on view 0's labels and the shifted
    cell correspondence."""
    det0, desc0, _, desc1 = forward_pair(model, batch.img0, batch.img1)
    B, hc, wc, _ = desc0.shape
    det_loss = cell_ce(det0, batch.labels0)

    # cell (i, j) of view 0 corresponds to cell (i + dy/8, j + dx/8) of
    # view 1, rounded to the nearest cell (half to even, as jnp.round)
    dcell = torch.round(batch.shift.to(torch.float32) / 8.0).long()
    dev = desc0.device
    ii = torch.arange(hc, device=dev)[None, :, None]
    jj = torch.arange(wc, device=dev)[None, None, :]
    ti = ii + dcell[:, 1][:, None, None]
    tj = jj + dcell[:, 0][:, None, None]
    in_bounds = (ti >= 0) & (ti < hc) & (tj >= 0) & (tj < wc)
    bidx = torch.arange(B, device=dev)[:, None, None]
    d1_at = desc1[bidx, ti.clamp(0, hc - 1), tj.clamp(0, wc - 1)]

    sim = torch.einsum(
        "bnd,bmd->bnm", desc0.reshape(B, hc * wc, -1), d1_at.reshape(B, hc * wc, -1)
    ) / 0.1
    nce = -torch.diagonal(torch.log_softmax(sim, dim=-1), dim1=1, dim2=2)
    mask = in_bounds.reshape(B, hc * wc).to(torch.float32)
    desc_loss = torch.sum(nce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return det_loss + desc_w * desc_loss, (det_loss, desc_loss)


def _allreduce_mean(loss: torch.Tensor, grads: list[torch.Tensor], group):
    """The loss and the gradients summed over `group` and divided by its
    size (`lax.pmean`), in one all-reduce of one flat buffer."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=group)
    flat = flat / n
    out, i = [], 0
    for g in grads:
        out.append(flat[i : i + g.numel()].view_as(g))
        i += g.numel()
    return flat[i], out


def make_step(model: nn.Module, optimizer: Adam, loss: Callable, group=None):
    """The step of every trainer: `step(batch) -> (loss, aux)`.

    `loss(model, batch) -> (total, aux)`; the batch is moved to the model's
    device; a parameter the loss does not reach gets a zero gradient, as
    `jax.grad` gives it. With `group` (a `torch.distributed` process
    group), the gradients and the loss are all-reduced to their mean
    first, so every rank applies the same update.
    """
    params = optimizer.params
    device = params[0].device

    def step(batch):
        batch = batch_to(batch, device)
        with torch.enable_grad():
            total, aux = loss(model, batch)
            grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        total = total.detach()
        if group is not None:
            total, grads = _allreduce_mean(total, grads, group)
        optimizer.step(grads)
        return total, tuple(a.detach() for a in aux)

    return step


def make_train_step(model: SuperPointBackbone, optimizer: Adam, group=None, desc_w: float = 1.0):
    """`loss_fn`'s train step; with `group`, data parallel over its ranks."""
    return make_step(model, optimizer, lambda m, b: loss_fn(m, b, desc_w), group)


def pretrain(
    steps: int = 300,
    batch: int = 16,
    lr: float = 1e-3,
    seed: int = 0,
    hw: tuple[int, int] = (96, 128),
    log_every: int = 50,
    device=None,
):
    """Run synthetic pretraining; returns (model, losses)."""
    from visualodometry_tpu_torch.models.superpoint import init_superpoint

    model = init_superpoint(torch.Generator().manual_seed(seed), hw, device=device)
    rng = np.random.default_rng(seed)
    opt = Adam(model.parameters(), lr)
    train_step = make_train_step(model, opt)
    losses = []
    for i in range(steps):
        loss, _ = train_step(synthetic_batch(rng, batch=batch, hw=hw))
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
    return model, losses


def save_params(model: nn.Module, path) -> None:
    """Pickle the model's parameters in the JAX trainers' layout (the Flax
    tree of numpy arrays), which JAX's `load_params` and the port's
    `load_flax_pickle` both read."""
    from visualodometry_tpu_torch.models.attention_matcher import AttentionMatcher

    state = model.state_dict()
    if isinstance(model, AttentionMatcher):
        params = convert.attention_flax_from_state_dict(state)
    else:
        params = convert.superpoint_flax_from_state_dict(state)
    with open(path, "wb") as f:
        pickle.dump(params, f)


def load_params(path) -> dict:
    """The Flax tree of numpy arrays in a weight file (`save_params`'s, or
    a bundled one); numpy arrays only."""
    return weights.load_flax_pickle(path)
