"""Shared machinery for batched (loop-free) RANSAC.

The estimators take their minimal-sample indices explicitly; the runner
draws them here from a `torch.Generator` on the device. (The JAX engine
draws from its PRNG key, so the two never give the same samples from one
seed; tests hand both the same indices.)
"""

from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1


def sample_valid_indices(
    gen: torch.Generator, valid: torch.Tensor, num_hypotheses: int, sample_size: int
) -> torch.Tensor:
    """Sample (H, k) indices of `True` entries of `valid`, with replacement.

    Valid indices are packed to the front by a stable argsort on ~valid and
    random draws are taken modulo the valid count; when nothing is valid
    the result is all zeros (callers gate on the count).
    """
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    count = torch.clamp(torch.sum(valid), min=1)
    draws = torch.randint(
        0, _INT32_MAX, (num_hypotheses, sample_size),
        generator=gen, device=valid.device,
    )
    return order[draws % count]


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a host synchronisation.

    Indexing with a 0-d CUDA tensor converts it to a Python int, which
    waits for the device; `index_select` stays on the device.
    """
    return x.index_select(0, i.reshape(1))[0]
