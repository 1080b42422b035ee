"""The port's distributed pieces (parallel/) on the CPU: the Schur BA with
landmark blocks sharded over ranks, the mesh and the runtime.

`ba_solve_distributed` runs in 4 spawned processes over gloo (map = 4, and
a 2 x 2 mesh), each rank holding its block of landmarks, and is held
against the JAX package's single-device `ba_solve` on
tests/test_distributed.py's problem (a copy of its generator) at that
file's tolerances: 1e-4 on poses, 1e-3 on landmarks. Every rank gets the
whole problem back. A one-rank mesh without a process group is the port's
`ba_solve` bit for bit. Each process is joined with a timeout, so a hang
fails the test instead of holding the suite.
"""

import multiprocessing
import queue as queue_mod
import socket

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers
from visualodometry_tpu.ba import BAProblem as JBAProblem
from visualodometry_tpu.ba import ba_solve as jba_solve
from visualodometry_tpu.parallel import make_mesh as jmake_mesh
from visualodometry_tpu_torch.ba import BAProblem, ba_solve
from visualodometry_tpu_torch.parallel import (
    Mesh,
    ba_solve_distributed,
    initialize_runtime,
    make_mesh,
    process_local_batch,
)
from visualodometry_tpu_torch.parallel.mesh import factor_mesh

torch.set_num_threads(2)

K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]], dtype=np.float32)
JOIN_TIMEOUT_S = 120


def _ba_problem(rng, P=5, L=256, noise=0.2):
    """tests/test_distributed.py's generator, as numpy arrays."""
    X = np.stack(
        [rng.uniform(-15, 15, L), rng.uniform(-4, 3, L), rng.uniform(10, 50, L)], axis=1
    ).astype(np.float32)
    T_cw, uv = [], np.zeros((L, P, 2), np.float32)
    mask = np.ones((L, P), bool)
    for p in range(P):
        w = np.array([0.0, 0.002 * p, 0.0])
        t = np.array([0.05 * p, 0.0, -1.2 * p])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = cv2.Rodrigues(w)[0]
        T[:3, 3] = t
        T_cw.append(T)
        proj, _ = cv2.projectPoints(X.astype(np.float64), w, t, K.astype(np.float64), None)
        uv[:, p] = proj.reshape(-1, 2)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    X_pert = X + rng.normal(0, 0.3, X.shape).astype(np.float32)
    return np.stack(T_cw), X_pert, uv, mask, K


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(target, world, *args):
    """Run `target` in `world` spawned processes; returns their results by
    rank. A worker that fails, hangs or dies fails the test."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, q, *args)) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):  # drain before joining
            rank, res = q.get(timeout=JOIN_TIMEOUT_S)
            assert not isinstance(res, str), f"rank {rank} failed:\n{res}"
            results[rank] = res
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT_S)
            assert not p.is_alive() and p.exitcode == 0, f"worker exit {p.exitcode}"
    except queue_mod.Empty:
        pytest.fail(f"distributed workers timed out after {JOIN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return results


def _jax_solve(arrays, iters):
    ref = jba_solve(JBAProblem(*(jnp.asarray(a) for a in arrays)), iters=iters, damping=1e-4)
    return np.asarray(ref.T_cw), np.asarray(ref.X)


@pytest.mark.parametrize("num_seq,num_map,L,iters", [(1, 4, 256, 6), (2, 2, 128, 4)])
def test_distributed_ba_over_gloo_matches_jax(num_seq, num_map, L, iters):
    """4 processes: map = 4 (tests/test_distributed.py's solve), and a
    2 x 2 mesh whose two seq rows each solve the whole problem over their
    own map group. Every rank holds the whole solved problem."""
    arrays = _ba_problem(np.random.default_rng(42), L=L)
    T_ref, X_ref = _jax_solve(arrays, iters)
    results = _spawn(_dist_workers.ba_worker, 4, arrays, num_seq, num_map, iters, 1e-4)
    assert sorted(r["coords"] for r in results.values()) == [
        (s, m) for s in range(num_seq) for m in range(num_map)]
    for r in results.values():
        np.testing.assert_allclose(r["T"], T_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["X"], X_ref, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(r["T"], results[0]["T"])
        np.testing.assert_array_equal(r["X"], results[0]["X"])


def test_one_rank_mesh_is_ba_solve_bit_for_bit():
    arrays = _ba_problem(np.random.default_rng(42), L=128)
    prob = BAProblem(*(torch.as_tensor(a) for a in arrays))
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"seq": 1, "map": 1} and mesh.group("map") is None
    dist = ba_solve_distributed(prob, mesh, iters=4, damping=1e-4)
    ref = ba_solve(prob, iters=4, damping=1e-4)
    assert torch.equal(dist.T_cw, ref.T_cw) and torch.equal(dist.X, ref.X)
    T_j, X_j = _jax_solve(arrays, 4)
    np.testing.assert_allclose(dist.T_cw.numpy(), T_j, rtol=1e-4, atol=1e-4)


def test_landmarks_not_divisible_raise():
    arrays = _ba_problem(np.random.default_rng(0), L=100)
    prob = BAProblem(*(torch.as_tensor(a) for a in arrays))
    mesh = Mesh(shape={"seq": 1, "map": 3}, rank=0, device=torch.device("cpu"),
                groups={"seq": None, "map": None})
    with pytest.raises(ValueError, match="not divisible"):
        ba_solve_distributed(prob, mesh, iters=1)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_factoring_follows_jax(n):
    """With neither axis given, the port factors n ranks as the JAX package
    factors n devices; given one axis, the other follows."""
    import jax

    jm = jmake_mesh(devices=jax.devices()[:n])
    assert factor_mesh(n) == (jm.shape["seq"], jm.shape["map"])
    assert factor_mesh(n, num_map=n) == (1, n)
    assert factor_mesh(n, num_seq=n) == (n, 1)
    with pytest.raises(ValueError):
        factor_mesh(n, num_seq=n + 1)


def test_runtime_across_two_processes():
    """`initialize_runtime` over gloo in 2 processes: the `RuntimeSpec`
    fields; each rank's block of a batch on the "seq" axis and its lanes
    of a batched state."""
    batch = np.arange(8 * 3).reshape(8, 3)
    results = _spawn(_dist_workers.runtime_worker, 2, batch)
    for rank, r in results.items():
        assert r["spec"] == dict(num_processes=2, process_id=rank, global_devices=2,
                                 local_devices=1, platform="cpu", backend="gloo")
        assert r["shape"] == {"seq": 2, "map": 1} and r["seq"] == rank
        np.testing.assert_array_equal(r["block"], batch[4 * rank : 4 * rank + 4])
        assert r["lanes"] == 2


def test_single_process_runtime_and_local_batch():
    spec = initialize_runtime(device="cpu")
    assert (spec.num_processes, spec.process_id, spec.platform, spec.backend) == (
        1, 0, "cpu", None)
    mesh = Mesh(shape={"seq": 2, "map": 1}, rank=1, device=torch.device("cpu"),
                groups={"seq": None, "map": None})
    x = torch.arange(6)
    assert torch.equal(process_local_batch(mesh, "seq", x), torch.tensor([3, 4, 5]))
    with pytest.raises(ValueError, match="not divisible"):
        process_local_batch(mesh, "seq", torch.arange(5))
    with pytest.raises(ValueError, match="several processes"):
        initialize_runtime(num_processes=2, device="cpu")
