"""The data-parallel SuperPoint train step: two gloo ranks against JAX.

The JAX reference is `__graft_entry__.dryrun_multichip`'s step:
`make_train_step(..., axis_name="seq")` under `shard_map` over a 2-device
("seq", "map") CPU mesh, the batch sharded on "seq", Adam(1e-3). The port
runs `make_train_step(..., group=mesh.group("seq"))` in two spawned
processes over gloo, each on its half of the same batch, from the same
weights (JAX's init, carried across).

- Against JAX: the mean loss within 1e-5 relative; Adam's first moment
  after the step (optax's `mu` = 0.1 x the mean gradient, the port's
  `exp_avg`) within 1e-4 of each parameter's largest entry. Parameters
  after the step are not compared: Adam's first step is lr x sign(g), and
  where |g| is at rounding level two correct implementations move a
  parameter in opposite directions.
- Exactly: both ranks hold bit-equal parameters and moments after the
  step; the all-reduced gradient is the one-process mean (g0 + g1) / 2 of
  the ranks' own half-batch gradients (this process's Adam on that mean
  gives the ranks' parameters and moments bit for bit); and each rank's
  half-batch gradient is the one this process computes on that half with
  one thread, as the ranks run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import _dist_workers
import chip_smoke
from visualodometry_tpu.models.superpoint import SuperPointBackbone as JBackbone
from visualodometry_tpu.models.train_superpoint import make_train_step as jmake_train_step
from visualodometry_tpu.models.train_superpoint import TrainBatch as JTrainBatch
from visualodometry_tpu.parallel import make_mesh as jmake_mesh
from visualodometry_tpu_torch.models import convert
from visualodometry_tpu_torch.models.optim import Adam
from visualodometry_tpu_torch.models.superpoint import SuperPointBackbone
from visualodometry_tpu_torch.models.train_superpoint import (
    TrainBatch,
    loss_fn,
    synthetic_batch,
)

WORLD, LR, TIMEOUT_S = 2, chip_smoke.TRAIN_DP_LR, 120


def _jax_step(params, arrays):
    """dryrun_multichip's sharded step; returns (loss, mu tree)."""
    mesh = jmake_mesh(num_seq=WORLD, num_map=1, devices=jax.devices()[:WORLD])
    model = JBackbone()
    tx = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(params)
    batch = JTrainBatch(*(jnp.asarray(a) for a in arrays))
    rep = P()
    step = shard_map(
        jmake_train_step(model, tx, axis_name="seq"), mesh=mesh,
        in_specs=(rep, rep, jax.tree.map(lambda _: P("seq"), batch)),
        out_specs=(rep, rep, rep, (rep, rep)), check_vma=False,
    )
    _, opt_state, loss, _ = step(params, opt_state, batch)
    return float(loss), jax.tree.map(np.asarray, opt_state[0].mu)


def test_two_rank_step_matches_jax_and_the_one_process_mean():
    jparams = JBackbone().init(jax.random.key(0), jnp.zeros((1, 32, 32, 1)))
    params = jax.tree.map(np.asarray, jparams)
    state = convert.superpoint_state_dict_from_flax(params)
    batch = synthetic_batch(np.random.default_rng(0), batch=2 * WORLD, hw=(32, 32),
                            n_points=6, max_shift=4)
    arrays = [t.numpy() for t in batch]
    # JAX compiles its step (~25 s) while the ranks run
    with ThreadPoolExecutor(1) as pool:
        jax_result = pool.submit(_jax_step, params, arrays)
        res = chip_smoke.spawn_ranks(_dist_workers.train_dp_worker, WORLD,
                                     {k: v.numpy() for k, v in state.items()}, arrays,
                                     timeout_s=TIMEOUT_S)
        loss_j, mu_j = jax_result.result(timeout=TIMEOUT_S)
    assert sorted(r["seq"] for r in res.values()) == list(range(WORLD))
    r0, r1 = res[0], res[1]
    for r in (r0, r1):
        np.testing.assert_allclose(r["loss"], loss_j, rtol=1e-5)
        assert r["loss"] == r0["loss"]
        for a, b in zip(r["params"], r0["params"]):
            np.testing.assert_array_equal(a, b)

    # against JAX: Adam's first moment, 0.1 x the mean gradient
    model = SuperPointBackbone()
    model.load_state_dict(state)
    names = [k for k, _ in model.named_parameters()]
    mu_t = convert.superpoint_flax_from_state_dict(
        {n: torch.as_tensor(m) for n, m in zip(names, r0["exp_avg"])})["params"]
    for layer, leaves in mu_j["params"].items():
        for part, m in leaves.items():
            err = np.abs(mu_t[layer][part] - m).max()
            assert err <= 1e-4 * np.abs(m).max(), (layer, part, err)

    # exactly: the all-reduce is the one-process mean of the halves
    mean = [(torch.as_tensor(a) + torch.as_tensor(b)) / WORLD
            for a, b in zip(r0["local"], r1["local"])]
    opt = Adam(model.parameters(), LR)
    opt.step(mean)
    for a, b in zip(opt.exp_avg, r0["exp_avg"]):
        np.testing.assert_array_equal(a.numpy(), b)
    for p, got in zip(model.parameters(), r0["params"]):
        np.testing.assert_array_equal(p.detach().numpy(), got)
    # and each rank's half-batch gradient is this process's on that half
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = SuperPointBackbone()
        ref.load_state_dict(state)
        for rank, r in res.items():
            half = TrainBatch(*(t[rank * 2:(rank + 1) * 2] for t in batch))
            grads = torch.autograd.grad(loss_fn(ref, half)[0], list(ref.parameters()))
            for g, local in zip(grads, r["local"]):
                np.testing.assert_array_equal(g.numpy(), local)
    finally:
        torch.set_num_threads(threads)
