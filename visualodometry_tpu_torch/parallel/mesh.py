"""A named ("seq", "map") grid of ranks.

Port of visualodometry_tpu/parallel/mesh.py. The JAX mesh is an array of
devices that one program spans; here a rank is one process driving one
device, and the mesh is the ranks of `torch.distributed` laid out row-major
on the grid: rank = seq_index * num_map + map_index. Axes:
  "seq" -- data parallel over concurrent sequences (parallel/multiseq.py);
  "map" -- landmark-block sharding inside the BA solve
           (parallel/distributed_ba.py).

A mesh made while `torch.distributed` is initialized carries one process
group per axis, the ranks that share this rank's coordinate on the other
axis (`torch.distributed.new_group`, made on every rank in the same order,
as the call requires). A mesh of one rank made without it needs no process
group, as `make_mesh` on one JAX device needs no runtime: its collectives
are skipped.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from visualodometry_tpu_torch._device import resolve_device

AXES = ("seq", "map")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the grid."""

    shape: dict  # axis name -> size
    rank: int  # this process's rank in the world
    device: torch.device  # the device this rank drives
    groups: dict  # axis name -> process group of this rank's line, or None

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        seq, map_ = divmod(self.rank, self.shape["map"])
        return {"seq": seq, "map": map_}[axis]

    def group(self, axis: str):
        """The process group of `axis` through this rank (None without
        `torch.distributed`: a one-rank mesh)."""
        return self.groups[axis]


def factor_mesh(n: int, num_seq: int | None = None, num_map: int | None = None):
    """(num_seq, num_map) for n ranks, by the JAX package's rule: with
    neither given, the largest seq <= sqrt(n) that divides n (favouring the
    map axis, the compute-heavy one)."""
    if num_seq is None and num_map is None:
        num_seq = next(s for s in range(math.isqrt(n), 0, -1) if n % s == 0)
        num_map = n // num_seq
    elif num_seq is None:
        if n % num_map:
            raise ValueError(f"make_mesh: {n} ranks do not split into map={num_map}")
        num_seq = n // num_map
    elif num_map is None:
        if n % num_seq:
            raise ValueError(f"make_mesh: {n} ranks do not split into seq={num_seq}")
        num_map = n // num_seq
    if num_seq * num_map != n:
        raise ValueError(f"make_mesh: seq={num_seq} x map={num_map} is not {n} ranks")
    return num_seq, num_map


def make_mesh(
    num_seq: int | None = None, num_map: int | None = None, device=None
) -> Mesh:
    """Build the ("seq", "map") mesh over the ranks of `torch.distributed`
    (one rank when it is not initialized) for this rank, driving `device`
    (CUDA unless "cpu" is asked for). Every rank must call it, in the same
    order as its other `new_group` calls."""
    import torch.distributed as dist

    dev = resolve_device(device)
    on = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    num_seq, num_map = factor_mesh(n, num_seq, num_map)
    groups = {"seq": None, "map": None}
    if on:
        lines = {
            "map": [[s * num_map + m for m in range(num_map)] for s in range(num_seq)],
            "seq": [[s * num_map + m for s in range(num_seq)] for m in range(num_map)],
        }
        for axis in AXES:
            for ranks in lines[axis]:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = g
    return Mesh(shape={"seq": num_seq, "map": num_map}, rank=rank, device=dev, groups=groups)
