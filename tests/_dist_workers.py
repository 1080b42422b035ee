"""Worker processes for tests/test_torch_distributed.py and
tests/test_torch_train_dp.py.

A module of its own, without JAX, so that each spawned process imports
only torch, the port and chip_smoke.py (which imports no JAX). Every
worker brings the runtime up on the CPU over gloo, does its part, puts its
result on the queue and tears down.
"""

import os
import sys
import traceback

# chip_smoke.py, at the root of the checkout, holds the data-parallel rank body
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(fn, rank, world, port, queue, *args):
    import torch

    torch.set_num_threads(1)
    from visualodometry_tpu_torch.parallel import initialize_runtime, shutdown_runtime

    try:
        spec = initialize_runtime(f"127.0.0.1:{port}", world, rank, device="cpu",
                                  timeout_s=120.0)
        queue.put((rank, fn(spec, *args)))
    except Exception:  # the parent reports the worker's traceback
        queue.put((rank, traceback.format_exc()))
    finally:
        shutdown_runtime()


def ba_worker(rank, world, port, queue, arrays, num_seq, num_map, iters, damping):
    def work(spec, arrays):
        import torch

        from visualodometry_tpu_torch.ba import BAProblem
        from visualodometry_tpu_torch.parallel import ba_solve_distributed, make_mesh

        mesh = make_mesh(num_seq=num_seq, num_map=num_map, device="cpu")
        prob = BAProblem(*(torch.as_tensor(a) for a in arrays))
        out = ba_solve_distributed(prob, mesh, iters=iters, damping=damping)
        return dict(coords=(mesh.coord("seq"), mesh.coord("map")),
                    T=out.T_cw.numpy(), X=out.X.numpy())

    _run(work, rank, world, port, queue, arrays)


def runtime_worker(rank, world, port, queue, batch):
    def work(spec, batch):
        import dataclasses

        from visualodometry_tpu_torch.parallel import make_mesh, process_local_batch
        from visualodometry_tpu_torch.parallel.multiseq import init_batched_state, shard_batched
        from visualodometry_tpu_torch.config import VOConfig

        mesh = make_mesh(num_seq=world, device="cpu")
        cfg = VOConfig(max_keypoints=64, sift_n_features=64, map_capacity=256)
        states = shard_batched(init_batched_state(cfg, 8, 2 * world, device="cpu"), mesh)
        return dict(spec=dataclasses.asdict(spec), seq=mesh.coord("seq"),
                    shape=mesh.shape, block=process_local_batch(mesh, "seq", batch),
                    lanes=int(states.frame_id.shape[0]))

    _run(work, rank, world, port, queue, batch)


def train_dp_worker(rank, world, port, queue, state, arrays):
    """One rank of the data-parallel SuperPoint step: chip_smoke.py's rank
    body (its shard's gradient, then the step over the mesh's "seq" axis)
    on the CPU, with the rank's "seq" coordinate."""
    def work(spec, state, arrays):
        import torch

        import chip_smoke
        from visualodometry_tpu_torch.parallel import make_mesh

        mesh = make_mesh(num_seq=world, device="cpu")
        res = chip_smoke._dp_step(torch, torch.device("cpu"), state, arrays, mesh)
        return dict(res, seq=mesh.coord("seq"))

    _run(work, rank, world, port, queue, state, arrays)
