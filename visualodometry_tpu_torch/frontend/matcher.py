"""Descriptor matching: batched L2 kNN (k=2) + Lowe ratio test.

Port of visualodometry_tpu/frontend/matcher.py. The top-2 search is
`ops.match_top2.match_top2`, which launches kernel K1 for CUDA tensors and
runs the plain PyTorch version for CPU tensors, so the choice of path is
the tensors' device (the JAX config's `matcher_backend` is not read).
The match contract is per query: `idx[i] = j` with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualodometry_tpu_torch.ops.match_top2 import _BIG, match_top2


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (N0,) int32 — index into frame-1 slots per query
    valid: torch.Tensor  # (N0,) bool — passed validity + ratio (+ mutual)


def match_descriptors(
    desc0: torch.Tensor,
    valid0: torch.Tensor,
    desc1: torch.Tensor,
    valid1: torch.Tensor,
    ratio: float = 0.75,
    mutual: bool = False,
) -> MatchResult:
    """kNN(k=2) + Lowe ratio over padded descriptor sets.

    desc0: (N0, D) queries (keyframe), desc1: (N1, D) train (current).
    Distances are squared-L2; the ratio test compares against ratio^2,
    which is OpenCV's `m.distance < ratio * n.distance` on L2. With
    `mutual`, a second top-2 pass in the other direction keeps only
    matches that are also the column-wise best.
    """
    n0 = desc0.shape[0]
    best_d2, second_d2, best_idx = match_top2(desc0, desc1, valid1)
    r2 = float(np.float32(ratio * ratio))
    ok = valid0 & (best_d2 < r2 * second_d2) & (best_d2 < _BIG)
    best_idx = best_idx.long()
    if mutual:
        _, _, best_col_of_row = match_top2(desc1, desc0, valid0)
        rows = torch.arange(n0, device=desc0.device)
        ok = ok & (best_col_of_row.long()[best_idx] == rows)
    return MatchResult(idx=best_idx.to(torch.int32), valid=ok)
