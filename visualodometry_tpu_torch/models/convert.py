"""Weight conversion between Flax parameter trees, torch SuperPoint
checkpoints and the port's state dicts.

Counterpart of visualodometry_tpu/models/convert.py, which maps a torch
SuperPoint checkpoint onto the Flax tree. Here the bundled Flax weights
(models/weights.py) become state dicts of the port's modules, and the
inverse converters turn a port-trained state dict back into the Flax tree
of numpy arrays, the layout the JAX trainers pickle
(`train_superpoint.save_params`).

- Convolutions: Flax kernels are HWIO, `nn.Conv2d` weights OIHW.
- Dense layers: Flax kernels are (in, out), `nn.Linear` weights (out, in).
"""

from __future__ import annotations

import re

import numpy as np
import torch

# SuperPoint's layer names, the same in the Flax tree, the magicleap and
# lightglue checkpoints, and the port's modules
SUPERPOINT_LAYERS = (
    "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a",
    "conv4b", "convPa", "convPb", "convDa", "convDb",
)
_CKPT_PREFIXES = ("module.", "superpoint.", "net.")


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


def _attention_key(path: tuple[str, ...], n_heads: int) -> str:
    """Flax path of an AttentionMatcher layer -> the port's module path."""
    name = path[0]
    if name == "Dense_0":
        return "pos_d0"
    if name == "Dense_1":
        return "pos_d1"
    if name == "in_proj":
        return "in_proj"
    m = re.fullmatch(r"block(\d+)", name)
    if m:
        inner = {"Dense_0": "mlp0", "Dense_1": "mlp1"}.get(path[1])
        tail = inner if inner else ".".join(path[1:])
        return f"blocks.{m.group(1)}.{tail}"
    for flax_name, port_name in (("out_proj", "out_projs"), ("matchability", "match_heads"),
                                 ("confidence", "conf_heads")):
        m = re.fullmatch(flax_name + r"(\d*)", name)
        if m:
            # the last (or only, when shared) head carries no index in Flax
            return f"{port_name}.{m.group(1) or n_heads - 1}"
    raise KeyError(f"attention matcher: unknown Flax layer {'/'.join(path)}")


def attention_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """State dict of `AttentionMatcher` from its Flax tree.

    Flax names: `Dense_0`/`Dense_1` (positional encoder), `in_proj`,
    `block{i}/{self,cross}_attn/{q,k,v,proj}`, `block{i}/Dense_{0,1}`
    (MLP), `out_proj[i]`, `matchability[i]`, `confidence{i}`.
    """
    tree = params["params"]
    n_heads = sum(1 for k in tree if re.fullmatch(r"out_proj\d*", k))
    out = {}

    def walk(node, path):
        if "kernel" in node:
            key = _attention_key(path, n_heads)
            out[f"{key}.weight"] = _tensor(np.asarray(node["kernel"]).T)
            if "bias" in node:
                out[f"{key}.bias"] = _tensor(node["bias"])
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(tree, ())
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())


def superpoint_flax_from_state_dict(state: dict) -> dict:
    """The Flax tree `{"params": {layer: {"kernel" (kh, kw, I, O), "bias"}}}`
    of a `SuperPointBackbone` or `SuperPointDense` state dict (the inverse of
    `superpoint_state_dict_from_flax`)."""
    tree = {}
    for key, t in state.items():
        layer, part = key.rsplit(".", 1)
        a = _array(t)
        tree.setdefault(layer, {})["kernel" if part == "weight" else "bias"] = (
            np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0))) if part == "weight" else a
        )
    return {"params": tree}


def _flax_attention_path(key: str, n_heads: int) -> tuple[str, ...]:
    """The port's module path of an AttentionMatcher layer -> its Flax path
    (the inverse of `_attention_key`)."""
    parts = key.split(".")
    top = {"pos_d0": "Dense_0", "pos_d1": "Dense_1", "in_proj": "in_proj"}
    if parts[0] in top:
        return (top[parts[0]],)
    if parts[0] == "blocks":
        inner = {"mlp0": ("Dense_0",), "mlp1": ("Dense_1",)}.get(parts[2], tuple(parts[2:]))
        return (f"block{parts[1]}",) + inner
    for port_name, flax_name in (("out_projs", "out_proj"), ("match_heads", "matchability")):
        if parts[0] == port_name:
            i = int(parts[1])
            return (flax_name if i == n_heads - 1 else f"{flax_name}{i}",)
    if parts[0] == "conf_heads":
        return (f"confidence{parts[1]}",)
    raise KeyError(f"attention matcher: unknown layer {key}")


def attention_flax_from_state_dict(state: dict) -> dict:
    """The Flax tree of an `AttentionMatcher` state dict (the inverse of
    `attention_state_dict_from_flax`): Linear (out, in) -> Dense (in, out)."""
    n_heads = len({k.split(".")[1] for k in state if k.startswith("out_projs.")})
    tree: dict = {}
    for key, t in state.items():
        layer, part = key.rsplit(".", 1)
        node = tree
        for name in _flax_attention_path(layer, n_heads):
            node = node.setdefault(name, {})
        a = _array(t)
        node["kernel" if part == "weight" else "bias"] = (
            np.ascontiguousarray(a.T) if part == "weight" else a
        )
    return {"params": tree}


def load_torch_superpoint(checkpoint_path: str) -> dict[str, torch.Tensor]:
    """State dict of `SuperPointBackbone` from a magicleap `superpoint_v1.pth`
    or lightglue `superpoint.pth` file: the layer names are the port's, so
    only the release's key prefixes are stripped."""
    state = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    cleaned = {}
    for k, v in state.items():
        for prefix in _CKPT_PREFIXES:
            if k.startswith(prefix):
                k = k[len(prefix):]
        cleaned[k] = v.to(torch.float32)
    out = {}
    for layer in SUPERPOINT_LAYERS:
        for part in ("weight", "bias"):
            key = f"{layer}.{part}"
            if key not in cleaned:
                raise KeyError(f"checkpoint missing {key}; found keys like {list(cleaned)[:5]}")
            out[key] = cleaned[key]
    return out
