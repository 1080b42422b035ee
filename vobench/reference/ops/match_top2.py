"""Top-2 L2 descriptor matching, plain: the reference for kernel K1.

Frozen copy of the plain version of visualodometry_tpu_torch/ops/
match_top2.py (`_top2_torch`): the full distance matrix and masked
reductions, on whatever device the tensors are on. No kernel.
"""

from __future__ import annotations

import torch

from vobench.reference.precision import mm

_BIG = 1e30


def _top2_torch(desc0, desc1, valid1):
    """Plain version: full distance matrix + masked reductions.

    Line-for-line port of `_top2_jnp` (visualodometry_tpu/frontend/
    matcher.py). Returns (best_d2, second_d2, best_idx int32). With a
    leading lane axis each lane goes through the 2-D version in turn, so a
    lane's result is bit-equal to its own 2-D call on the CPU.
    """
    if desc0.dim() == 3:
        lanes = [_top2_torch(a, b, v) for a, b, v in zip(desc0, desc1, valid1)]
        return tuple(torch.stack(x) for x in zip(*lanes))
    sq0 = torch.sum(desc0 * desc0, dim=1)
    sq1 = torch.sum(desc1 * desc1, dim=1)
    cross = mm(desc0, desc1.T)
    d2 = sq0[:, None] + sq1[None, :] - 2.0 * cross
    d2 = torch.clamp(d2, min=0.0)
    d2 = torch.where(valid1[None, :], d2, _BIG)

    best_idx = torch.argmin(d2, dim=1)  # first minimum on ties
    best_d2 = torch.gather(d2, 1, best_idx[:, None])[:, 0]
    rows = torch.arange(d2.shape[0], device=d2.device)
    d2_wo_best = d2.clone()
    d2_wo_best[rows, best_idx] = _BIG
    second_d2 = torch.min(d2_wo_best, dim=1).values
    return best_d2, second_d2, best_idx.to(torch.int32)


def match_top2(desc0: torch.Tensor, desc1: torch.Tensor, valid1: torch.Tensor):
    """(best_d2, second_d2, best_idx) of each query row; see `_top2_torch`."""
    return _top2_torch(desc0, desc1, valid1)
