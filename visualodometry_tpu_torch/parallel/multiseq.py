"""Data-parallel multi-sequence VO: B sequences stepped together on a card.

Port of visualodometry_tpu/parallel/multiseq.py. The JAX package vmaps the
step over a lane axis, which turns its `lax.cond`s into selects that run
every branch in every lane, and shards the lane axis over the mesh's "seq"
axis. The port's step branches on the host (core/step.py), which does not
vmap, so a frame of B lanes runs so:

1. one batched match: kernel K1 matches every lane's keyframe against its
   frame in one launch (`match_descriptors` with a lane axis); the
   attention matcher, which has no lane axis, loops over the lanes;
2. one host read of every lane's branch gates, a (B, 5) `.tolist()`;
3. each lane's branch work is queued: the essential RANSAC or the PnP
   RANSAC, each on the lane's own draws;
4. one more host read of all lanes' solver flags (ess.ok; pnp.ok and the
   keyframe decision), and each lane finishes.

So a frame costs the single step's 2 synchronisations whatever B is (one
more on an initialisation frame with `cfg.min_init_landmarks` > 0, as the
single step), while the kernel launches of steps 3 and 4 grow with B. Lane
b is the single step run alone on lane b's features with the same draws,
exactly on the CPU: each lane runs only its own branch, where vmap's
selects run them all.

Lane b draws from a `torch.Generator` seeded `cfg.seed + b`, as the JAX
package seeds lane i's key (b counts the mesh's lanes: a rank at "seq"
index r holding B lanes starts at r * B). The step has no collective; on a
mesh each rank steps its own lanes (`shard_batched`).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from visualodometry_tpu_torch._device import resolve_device
from visualodometry_tpu_torch.config import VOConfig
from visualodometry_tpu_torch.core.runner import unstack_features
from visualodometry_tpu_torch.core.state import (
    StepOutput,
    VOState,
    init_state,
    lane_state,
    stack_states,
)
from visualodometry_tpu_torch.core.step import (
    Sampler,
    StepParts,
    generator_sampler,
    make_match_fn,
)
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.frontend.matcher import MatchResult
from visualodometry_tpu_torch.parallel.mesh import Mesh
from visualodometry_tpu_torch.parallel.runtime import process_local_batch


def init_batched_state(cfg: VOConfig, desc_dim: int, batch: int, device=None) -> VOState:
    """A batch of fresh VO states, stacked on a leading lane axis, on
    `device` (CUDA unless "cpu" is asked for). Their RANSAC streams are the
    multi-sequence step's per-lane generators."""
    dev = resolve_device(device)
    return stack_states([init_state(cfg, desc_dim, device=dev) for _ in range(batch)])


def shard_batched(tree, mesh: Mesh, axis: str = "seq"):
    """This rank's lanes of a batched tree (state, features, frames: tensors
    or numpy arrays) on the mesh's device: B / n lanes, for n the size of
    `axis`."""

    def to_device(x):
        if hasattr(x, "_fields"):
            return type(x)(*(to_device(v) for v in x))
        return torch.as_tensor(x).to(mesh.device)

    return to_device(process_local_batch(mesh, axis, tree))


def make_multiseq_step_fn(
    cfg: VOConfig,
    K,
    mesh: Mesh | None = None,
    axis: str = "seq",
    device=None,
    samplers: Sequence[Sampler] | None = None,
    matcher_params=None,
) -> Callable[[VOState, Features], tuple[VOState, StepOutput]]:
    """The step over B sequences: `mstep(states, feats) -> (states, outs)`.

    `states` is a batched `VOState` (`init_batched_state`), `feats` a
    `Features` stacked on the same lane axis (or a list of B `Features`);
    `outs` is a `StepOutput` with the lane axis leading. K: (3, 3) shared
    intrinsics. Runs on the mesh's device, else on `device` (CUDA unless
    "cpu" is asked for). `samplers` gives each lane its own draws (tests
    pass the JAX engine's); by default lane b's generator is seeded
    cfg.seed + b, made on the first call, and kept as `mstep.generators`.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    match_fn = make_match_fn(cfg, dev, matcher_params)
    parts = StepParts(cfg, torch.as_tensor(np.asarray(K, np.float32), device=dev), dev)
    lane0 = 0 if mesh is None else mesh.coord(axis)

    def lane_samplers(B: int) -> list:
        if samplers is not None:
            if len(samplers) != B:
                raise ValueError(f"multiseq step: {len(samplers)} samplers for {B} lanes")
            return list(samplers)
        if mstep.generators is None:
            gens = []
            for b in range(B):
                g = torch.Generator(device=dev)
                g.manual_seed(cfg.seed + lane0 * B + b)
                gens.append(g)
            mstep.generators = gens
        if len(mstep.generators) != B:
            raise ValueError(
                f"multiseq step: built for {len(mstep.generators)} lanes, called with {B}"
            )
        return [generator_sampler(g) for g in mstep.generators]

    def match_lanes(states: VOState, feats: Features, lanes: list) -> list:
        if cfg.matcher_type == "ratio":  # K1 takes the lane axis: one launch
            m = match_fn(states.keyframe, feats)
            return [MatchResult(m.idx[b], m.valid[b]) for b in range(len(lanes))]
        return [match_fn(s.keyframe, f) for s, f in lanes]

    def mstep(states: VOState, feats) -> tuple[VOState, StepOutput]:
        if not isinstance(feats, Features):
            feats = stack_states(list(feats))
        B = states.frame_id.shape[0]
        draws = lane_samplers(B)
        lanes = [(lane_state(states, b), f) for b, f in enumerate(unstack_features(feats))]
        fronts = [
            parts.front(s, f, m)
            for (s, f), m in zip(lanes, match_lanes(states, feats, lanes))
        ]
        # one host read: every lane's branch gates
        gates = torch.stack([fr.gates for fr in fronts]).tolist()
        qs = [
            parts.queue(s, f, fr, g, draw)
            for (s, f), fr, g, draw in zip(lanes, fronts, gates, draws)
        ]
        while True:  # one read for all the lanes that wait on a solver
            waiting = [b for b, q in enumerate(qs) if q.flags is not None]
            if not waiting:
                break
            flags = torch.cat([qs[b].flags for b in waiting]).tolist()
            for b in waiting:
                k = qs[b].flags.numel()
                qs[b], flags = qs[b].finish(flags[:k]), flags[k:]
        return stack_states([q.state for q in qs]), stack_states([q.out for q in qs])

    mstep.generators = None
    return mstep
