"""The fixed-shape feature contract shared by the extractor and the core.

N is the config's padded slot count and `valid` marks live slots, as in
the JAX engine (visualodometry_tpu/frontend/interface.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device


class Features(NamedTuple):
    """Per-frame features at fixed shape.

    kps:   (N, 2) float32 pixel coordinates (x, y); garbage where ~valid.
    desc:  (N, D) float32 L2-normalized descriptors; zero where ~valid.
    valid: (N,) bool live-slot mask.
    """

    kps: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.kps.shape[0]


def pad_features(kps, desc, num_slots: int, device=None) -> Features:
    """Pack variable-count host features into the fixed-shape contract,
    on `device` (CUDA unless "cpu" is asked for)."""
    device = resolve_device(device)
    n = min(len(kps), num_slots)
    d = desc.shape[1] if len(desc) else 128
    kps_out = np.zeros((num_slots, 2), dtype=np.float32)
    desc_out = np.zeros((num_slots, d), dtype=np.float32)
    valid = np.zeros(num_slots, dtype=bool)
    kps_out[:n] = kps[:n]
    desc_out[:n] = desc[:n]
    valid[:n] = True
    return Features(
        kps=torch.as_tensor(kps_out, device=device),
        desc=torch.as_tensor(desc_out, device=device),
        valid=torch.as_tensor(valid, device=device),
    )
