"""Synthetic training for the attention matcher.

Port of visualodometry_tpu/models/train_matcher.py: planted-correspondence
problems (noisy descriptor twins at geometrically consistent positions,
distractors, dropped slots), the dual-softmax assignment cross entropy plus
a matchability BCE (`matcher_loss`), and the deep-supervision loss of the
per-layer-heads matcher (`matcher_loss_deep`).

The JAX losses `jax.vmap` a per-pair function; here the matcher takes the
batch of pairs as a leading axis (models/attention_matcher.py), so a step
is one pass over all pairs. Masked similarities are -1e9, not -inf, as in
the JAX package (a row with no valid key then stays finite).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.models.attention_matcher import (
    AttentionMatcher,
    adaptive_match,
    assignment_from_scores,
)
from visualodometry_tpu_torch.models.optim import Adam
from visualodometry_tpu_torch.models.train_superpoint import _tensors, batch_to, make_step

_NEG = -1e9


class MatchBatch(NamedTuple):
    kps0: torch.Tensor  # (B, N, 2) normalized [-1, 1]
    desc0: torch.Tensor  # (B, N, D)
    valid0: torch.Tensor  # (B, N)
    kps1: torch.Tensor
    desc1: torch.Tensor
    valid1: torch.Tensor
    gt_idx: torch.Tensor  # (B, N) target index in set 1, -1 = unmatched


def synthetic_match_batch(
    rng: np.random.Generator,
    batch: int = 8,
    n: int = 128,
    d: int = 128,
    pair_frac: float = 0.6,
    desc_noise: float = 0.25,
    pos_noise: float = 0.01,
    flow_scale: float = 0.15,
) -> MatchBatch:
    """Planted-correspondence problems with a smooth coherent flow field."""
    k0 = rng.uniform(-1, 1, (batch, n, 2)).astype(np.float32)
    base = rng.normal(size=(batch, n, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)

    n_pairs = int(pair_frac * n)
    gt = np.full((batch, n), -1, np.int32)

    k1 = rng.uniform(-1, 1, (batch, n, 2)).astype(np.float32)
    d1 = rng.normal(size=(batch, n, d)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)

    for b in range(batch):
        perm = rng.permutation(n)[:n_pairs]
        # coherent smooth flow: global translation + small rotation
        t = rng.uniform(-flow_scale, flow_scale, 2)
        ang = rng.uniform(-0.05, 0.05)
        c, s = np.cos(ang), np.sin(ang)
        Rm = np.array([[c, -s], [s, c]], np.float32)
        moved = k0[b, :n_pairs] @ Rm.T + t
        k1[b, perm] = moved + rng.normal(0, pos_noise, (n_pairs, 2))
        d1[b, perm] = base[b, :n_pairs] + desc_noise * rng.normal(size=(n_pairs, d))
        d1[b, perm] /= np.linalg.norm(d1[b, perm], axis=-1, keepdims=True)
        gt[b, :n_pairs] = perm

    d0 = base + desc_noise * rng.normal(size=base.shape).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)

    valid0 = np.ones((batch, n), bool)
    valid1 = np.ones((batch, n), bool)
    # drop some slots (padding realism); drops invalidate their gt pairs
    for b in range(batch):
        k0_drop = rng.choice(n, n // 8, replace=False)
        k1_drop = rng.choice(n, n // 8, replace=False)
        valid0[b, k0_drop] = False
        valid1[b, k1_drop] = False
        gt[b, k0_drop] = -1
        gt[b, np.isin(gt[b], k1_drop)] = -1

    return MatchBatch(*_tensors(k0, d0.astype(np.float32), valid0, k1,
                                d1.astype(np.float32), valid1, gt))


def _masked(sim, v0, v1):
    sim = torch.where(v1[:, None, :], sim, _NEG)
    return torch.where(v0[:, :, None], sim, _NEG)


def _bce(p, t):
    return -(t * torch.log(p + 1e-6) + (1 - t) * torch.log(1 - p + 1e-6))


def _masked_mean(x, mask):
    """Per pair: sum of x where mask over the count of mask (at least 1)."""
    return torch.sum(torch.where(mask, x, 0.0), dim=1) / torch.clamp(mask.sum(1), min=1)


def _assign_ce(sim, gt_c):
    """Per slot: -log_softmax over the row, at the ground-truth column."""
    return -torch.gather(torch.log_softmax(sim, dim=2), 2, gt_c[..., None])[..., 0]


def _inputs(batch: MatchBatch):
    return batch.kps0, batch.desc0, batch.valid0, batch.kps1, batch.desc1, batch.valid1


def matcher_loss(model: AttentionMatcher, batch: MatchBatch):
    """Mean over pairs of the assignment CE over ground-truth slots plus
    half the matchability BCE over valid slots."""
    sim, m0, _ = model(*_inputs(batch))
    v0, gt = batch.valid0, batch.gt_idx.long()
    sim = _masked(sim, v0, batch.valid1)
    has_gt = gt >= 0
    assign = _masked_mean(_assign_ce(sim, gt.clamp(0, sim.shape[2] - 1)), has_gt)
    match = _masked_mean(_bce(m0, has_gt.to(torch.float32)), v0)
    return torch.mean(assign + 0.5 * match)


def matcher_loss_deep(model: AttentionMatcher, batch: MatchBatch):
    """Deep-supervision loss of the per-layer-heads matcher.

    Every layer's heads predict the assignment (CE) and matchability
    (BCE), weighted (layer + 1) / L; each non-final layer's confidence is
    trained (BCE, weight 0.25) to predict whether the slot's current row or
    column argmax equals the final layer's. The final argmaxes are integer
    targets and carry no gradient (`stop_gradient` in JAX).
    """
    outs = model.all_layers(*_inputs(batch))
    v0, v1, gt = batch.valid0, batch.valid1, batch.gt_idx.long()
    L = len(outs)
    final_sim = _masked(outs[-1][0], v0, v1)
    fin0 = torch.argmax(final_sim, dim=2)  # (B, N0) final row argmax
    fin1 = torch.argmax(final_sim, dim=1)  # (B, N1)
    has_gt = gt >= 0
    gt_c = gt.clamp(0, final_sim.shape[2] - 1)
    target0 = has_gt.to(torch.float32)
    n_valid = torch.clamp(v0.sum(1) + v1.sum(1), min=1)

    total = 0.0
    w_sum = 0.0
    for layer, (sim_raw, m0, _, c0, c1) in enumerate(outs):
        w = (layer + 1) / L
        sim = _masked(sim_raw, v0, v1)
        assign = _masked_mean(_assign_ce(sim, gt_c), has_gt)
        mloss = _masked_mean(_bce(m0, target0), v0)
        total = total + w * (assign + 0.5 * mloss)
        w_sum = w_sum + w
        if layer < L - 1:
            agree0 = (torch.argmax(sim, dim=2) == fin0).to(torch.float32)
            agree1 = (torch.argmax(sim, dim=1) == fin1).to(torch.float32)
            closs = (
                torch.sum(torch.where(v0, _bce(c0, agree0), 0.0), 1)
                + torch.sum(torch.where(v1, _bce(c1, agree1), 0.0), 1)
            ) / n_valid
            total = total + 0.25 * closs
    return torch.mean(total / w_sum)


def make_matcher_step(model: AttentionMatcher, optimizer: Adam, deep: bool = False, group=None):
    """`step(batch) -> loss`: one Adam step on `matcher_loss` (or
    `matcher_loss_deep`)."""
    loss = matcher_loss_deep if deep else matcher_loss
    step = make_step(model, optimizer, lambda m, b: (loss(m, b), ()), group)
    return lambda batch: step(batch)[0]


@torch.no_grad()
def evaluate(model: AttentionMatcher, batch: MatchBatch, threshold: float = 0.2):
    """Precision and recall of the assignment on a batch (one batched
    forward, then each pair's dual-softmax mutual assignment)."""
    dev = next(model.parameters()).device
    batch = batch_to(batch, dev)
    sim, m0, m1 = model(*_inputs(batch))
    tp_fp_fn = np.zeros(3, np.int64)
    for b in range(sim.shape[0]):
        res = assignment_from_scores(sim[b], m0[b], m1[b], batch.valid0[b], batch.valid1[b],
                                     threshold=threshold)
        tp_fp_fn += _counts(res.idx.cpu().numpy(), res.valid.cpu().numpy(),
                            batch.gt_idx[b].cpu().numpy())
    tp, fp, fn = tp_fp_fn.tolist()
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


def _counts(idx: np.ndarray, ok: np.ndarray, gt: np.ndarray) -> np.ndarray:
    return np.array([np.sum(ok & (gt == idx)), np.sum(ok & (gt != idx)),
                     np.sum(~ok & (gt >= 0))])


@torch.no_grad()
def evaluate_adaptive(model: AttentionMatcher, data: dict, prune_to: int = 1024,
                      exit_conf: float = 0.95, threshold: float = 0.2):
    """Precision and recall of `adaptive_match` (the deployed path, pruning
    and early exit) over every pair of a dataset dict at its full width."""
    dev = next(model.parameters()).device
    tp_fp_fn = np.zeros(3, np.int64)
    for b in range(len(data["kps0"])):
        args = (torch.as_tensor(data[k][b], device=dev)
                for k in ("kps0", "desc0", "valid0", "kps1", "desc1", "valid1"))
        res = adaptive_match(model, *args, prune_to=prune_to, exit_conf=exit_conf,
                             threshold=threshold)
        tp_fp_fn += _counts(res.idx.cpu().numpy(), res.valid.cpu().numpy(), data["gt_idx"][b])
    tp, fp, fn = tp_fp_fn.tolist()
    return tp / max(tp + fp, 1), tp / max(tp + fn, 1)


def train_matcher(
    steps: int = 200,
    batch: int = 8,
    n: int = 128,
    d: int = 128,
    depth: int = 4,
    lr: float = 1e-4,
    seed: int = 0,
    log_every: int = 50,
    device=None,
):
    """Train from the identity-residual init; returns (model, losses)."""
    model = AttentionMatcher(desc_dim=d, depth=depth)
    model.init_identity_residual(torch.Generator().manual_seed(seed))
    model = model.to(resolve_device(device))
    rng = np.random.default_rng(seed)
    synthetic_match_batch(rng, batch=1, n=n, d=d)  # the JAX init's draw
    step = make_matcher_step(model, Adam(model.parameters(), lr))
    losses = []
    for i in range(steps):
        # curriculum over descriptor ambiguity: easy to near-random twins
        noise = float(rng.uniform(0.15, 0.5))
        loss = step(synthetic_match_batch(rng, batch=batch, n=n, d=d, desc_noise=noise))
        if i % log_every == 0 or i == steps - 1:
            losses.append(float(loss))
    return model, losses
