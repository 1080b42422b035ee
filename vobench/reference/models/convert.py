"""SuperPoint weights: a Flax parameter tree as a state dict.

Frozen copy of `superpoint_state_dict_from_flax` from
visualodometry_tpu_torch/models/convert.py: Flax convolution kernels are
HWIO, `nn.Conv2d` weights OIHW.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float32)))


def superpoint_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """State dict of `SuperPointBackbone` or `SuperPointDense` from a Flax
    tree `{"params": {layer: {"kernel" (kh, kw, I, O), "bias"}}}`."""
    out = {}
    for layer, p in params["params"].items():
        out[f"{layer}.weight"] = _tensor(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        out[f"{layer}.bias"] = _tensor(p["bias"])
    return out
