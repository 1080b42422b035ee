"""The port's dropping scatter against the JAX package's, on the CPU.

`core/state.scatter_drop` stands for `dst.at[index].set(src, mode="drop")`
at every drop-scatter of the JAX step (map insertion, keyframe creation,
id propagation, the KLT refill, the BA write-back). Its indices repeat:
the ratio matcher is not one-to-one, so two keyframe rows can name the
same current slot. XLA's scatter on the CPU runs its updates in order, so
the last of repeated entries wins; an indexed write in torch keeps an
arbitrary one on CUDA and on a CPU with several threads. The port's
function must give JAX's result bit for bit, on four threads, at the
4096 slots of the KITTI configurations. Values are copied on both sides,
so the comparison is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualodometry_tpu_torch.core.state import scatter_drop

# (slots, trailing shape, destination dtype); "many duplicates": the
# entries aim at n // 8 + 1 slots, and a fifth of them at n (dropped)
CASES = [
    (4096, (), np.int32),  # curr_ids, map ids
    (4096, (3,), np.float32),  # map points
    (4096, (2,), np.float32),  # KLT keypoints
    (4096, (4, 4), np.float32),  # KLT first poses
    (4096, (), np.bool_),  # KLT valid
    (64, (), np.float32),
]


def _jax_drop_scatter(dst, idx, src):
    return np.asarray(jnp.asarray(dst).at[jnp.asarray(idx)].set(jnp.asarray(src), mode="drop"))


def _inputs(n, rows, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        dst = rng.random((n,) + rows) < 0.5
        src = rng.random((n,) + rows) < 0.5
    elif dtype == np.int32:
        dst = rng.integers(-1, 1 << 20, size=(n,) + rows).astype(np.int32)
        src = rng.integers(-1, 1 << 20, size=(n,) + rows).astype(np.int32)
    else:
        dst = rng.normal(size=(n,) + rows).astype(dtype)
        src = rng.normal(size=(n,) + rows).astype(dtype)
    idx = rng.integers(0, n // 8 + 1, size=n).astype(np.int32)
    idx[rng.random(n) < 0.2] = n
    return dst, idx, src


@pytest.mark.parametrize("n, rows, dtype", CASES)
def test_scatter_drop_keeps_the_last_duplicate_like_jax(n, rows, dtype):
    # exact: both sides copy values
    dst, idx, src = _inputs(n, rows, dtype, seed=n + len(rows))
    want = _jax_drop_scatter(dst, idx, src)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for _ in range(3):  # a thread race would show in some repeat
            got = scatter_drop(torch.as_tensor(dst), torch.as_tensor(idx), torch.as_tensor(src))
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        torch.set_num_threads(threads)
    assert got.dtype == torch.as_tensor(dst).dtype and got.shape == dst.shape


def test_jax_drop_scatter_is_last_wins_on_the_cpu():
    """What the port matches: on the CPU, JAX keeps the last of repeated
    entries and drops index n, read off a hand-made case."""
    dst = np.zeros(4, np.int32)
    idx = np.array([1, 1, 4, 2, 1, 2], np.int32)
    src = np.array([10, 11, 12, 13, 14, 15], np.int32)
    np.testing.assert_array_equal(_jax_drop_scatter(dst, idx, src), [0, 14, 15, 0])
    got = scatter_drop(torch.as_tensor(dst), torch.as_tensor(idx), torch.as_tensor(src))
    np.testing.assert_array_equal(got.numpy(), [0, 14, 15, 0])
