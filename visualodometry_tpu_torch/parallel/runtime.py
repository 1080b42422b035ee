"""Multi-process runtime: `torch.distributed` brought up and torn down.

Port of visualodometry_tpu/parallel/runtime.py. The JAX package connects
its processes with `jax.distributed.initialize`, after which one program
spans every device. Here each process is one rank driving one device, and
`initialize_runtime` wraps `torch.distributed.init_process_group` with a
`tcp://` rendezvous at the coordinator's address: NCCL for CUDA, gloo for
the CPU. NCCL refuses two ranks on one GPU ("Duplicate GPU detected"), so
ranks that share a card pass `backend="gloo"`; gloo takes CUDA tensors in
`all_reduce` and `broadcast`, the only collectives the port makes
(parallel/distributed_ba.py).

Nothing on a machine tells a program of a cluster: the caller gives the
coordinator's address, the number of processes and this one's id.
Single-process callers (num_processes in (None, 1) and no coordinator)
skip `init_process_group`, as the JAX function skips
`jax.distributed.initialize`.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta

import torch

from visualodometry_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """What `initialize_runtime` brought up."""

    num_processes: int
    process_id: int
    global_devices: int
    local_devices: int
    platform: str  # "gpu" or "cpu"
    backend: str | None = None  # the process group's backend; None for one process


def initialize_runtime(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    device=None,
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> RuntimeSpec:
    """Bring up the process group and report the topology.

    `coordinator_address` is "host:port" of rank 0; `num_processes` and
    `process_id` are the world size and this rank. A rank drives one
    device: `local_device_ids` (at most one id) picks the CUDA device, else
    `device` (CUDA unless "cpu" is asked for). `backend` defaults to NCCL on
    CUDA and gloo on the CPU. `timeout_s` bounds each collective's wait.
    """
    if local_device_ids is not None:
        if len(local_device_ids) != 1:
            raise ValueError("initialize_runtime: a rank drives exactly one device")
        device = torch.device("cuda", local_device_ids[0])
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    platform = "gpu" if dev.type == "cuda" else "cpu"
    multiproc = coordinator_address is not None or (num_processes or 1) > 1
    if not multiproc:
        return RuntimeSpec(num_processes=1, process_id=0, global_devices=1,
                           local_devices=1, platform=platform)
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize_runtime: several processes need the coordinator's address, "
            "num_processes and process_id"
        )
    import torch.distributed as dist

    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s),
    )
    return RuntimeSpec(
        num_processes=dist.get_world_size(), process_id=dist.get_rank(),
        global_devices=dist.get_world_size(), local_devices=1, platform=platform,
        backend=dist.get_backend(),
    )


def shutdown_runtime() -> None:
    """Tear the process group down (multi-process runs only)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_local_batch(mesh, axis: str, batch):
    """This rank's block of `batch`, sharded on the mesh's `axis`.

    `batch` is a tensor, a numpy array, or a NamedTuple of them (a batched
    state, stacked features) with the leading axis B divisible by the axis
    size; the block of rank i along `axis` is rows [i B / n, (i + 1) B / n).
    The JAX function assembles a global array from each process's block;
    here there is no global array, and each rank keeps its own block. Each
    rank thus decodes or renders only its own sequences.
    """
    n, i = mesh.shape[axis], mesh.coord(axis)

    def block(x):
        if hasattr(x, "_fields"):
            return type(x)(*(block(v) for v in x))
        B = x.shape[0]
        if B % n:
            raise ValueError(f"process_local_batch: batch {B} not divisible by {axis}={n}")
        return x[i * (B // n) : (i + 1) * (B // n)]

    return block(batch)
