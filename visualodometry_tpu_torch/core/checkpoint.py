"""VO state checkpoint / resume.

Port of visualodometry_tpu/core/checkpoint.py: the full fixed-shape VO
state (pose, keyframe, landmark ring buffer, speed-smoothing scalars)
goes into a single .npz through `state_to_numpy`, and comes back through
`state_from_numpy`. The JAX state carries its PRNG key; here the RANSAC
draws come from the step's `torch.Generator`, so its state is saved
beside the VO state and restored into the generator handed to
`load_state`. A state saved after frame n and loaded then gives the same
outputs for frames n+1.. as the uninterrupted run (bit for bit on the
CPU).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from visualodometry_tpu_torch.core.state import (
    VOState,
    state_from_numpy,
    state_to_numpy,
)

_FORMAT_VERSION = 1
_RNG_KEY = "__rng_state__"


def _flatten(state: VOState) -> dict[str, np.ndarray]:
    flat = {}
    for name, leaf in state_to_numpy(state).items():
        if isinstance(leaf, dict):
            for sub, arr in leaf.items():
                flat[f"{name}.{sub}"] = arr
        else:
            flat[name] = leaf
    return flat


def save_state(
    state: VOState, path: str | Path, generator: torch.Generator | None = None
) -> None:
    """Write `state` (and the RANSAC generator's state) to `path` (.npz)."""
    flat = _flatten(state)
    flat["__version__"] = np.asarray(_FORMAT_VERSION)
    if generator is not None:
        flat[_RNG_KEY] = generator.get_state().cpu().numpy()
    np.savez_compressed(path, **flat)


def load_state(
    path: str | Path, template: VOState, generator: torch.Generator | None = None
) -> VOState:
    """Restore a state with the shapes, types and device of `template`.

    With `generator`, the saved generator state is written into it; a
    checkpoint that holds none then raises.
    """
    with np.load(path) as data:
        if int(data["__version__"]) != _FORMAT_VERSION:
            raise ValueError(f"checkpoint version {int(data['__version__'])}")
        want = _flatten(template)
        nested: dict = {}
        for key, ref in want.items():
            arr = data[key]
            if arr.shape != ref.shape or arr.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint leaf {key}: {arr.dtype}{arr.shape} does not "
                    f"fit the template's {ref.dtype}{ref.shape}"
                )
            name, _, sub = key.partition(".")
            if sub:
                nested.setdefault(name, {})[sub] = arr
            else:
                nested[name] = arr
        if generator is not None:
            if _RNG_KEY not in data:
                raise ValueError("checkpoint holds no generator state")
            generator.set_state(torch.as_tensor(data[_RNG_KEY]))
    return state_from_numpy(nested, device=template.T_wc.device)
