"""Port matcher (K1's plain version and `match_descriptors`) vs JAX.

- `_top2_torch` is held against the JAX float32 reference `_top2_jnp`
  exactly (1e-5 on distances; argbest equal away from near-ties), which is
  also what kernel K1 is held to on the card (chip_smoke.py).
- Against the Pallas kernel run in interpret mode (as tests/test_match.py
  runs it), only ratio-test outcomes are compared: that kernel forms the
  cross term with bf16 products, the port with float32 ones.

K1 itself runs only on the card: tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualodometry_tpu.frontend.matcher import _top2_jnp
from visualodometry_tpu.frontend.matcher import match_descriptors as jmatch
from visualodometry_tpu.ops.match_pallas import match_top2_pallas
from visualodometry_tpu_torch.frontend.matcher import match_descriptors as tmatch
from visualodometry_tpu_torch.ops import match_top2 as tk

torch.set_num_threads(2)


def _sets(rng, n0=256, n1=384, d=128, n_pairs=120):
    base = rng.normal(size=(n_pairs, d)).astype(np.float32)
    d0 = rng.normal(size=(n0, d)).astype(np.float32)
    d1 = rng.normal(size=(n1, d)).astype(np.float32)
    d0[:n_pairs] = base + 0.05 * rng.normal(size=(n_pairs, d))
    d1[:n_pairs] = base + 0.05 * rng.normal(size=(n_pairs, d))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    valid0 = rng.random(n0) > 0.05
    valid1 = rng.random(n1) > 0.1
    return d0, d1, valid0, valid1


def test_top2_plain_matches_jnp_reference():
    rng = np.random.default_rng(0)
    d0, d1, _, valid1 = _sets(rng)
    b_j, s_j, i_j = (np.asarray(x) for x in _top2_jnp(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(valid1)))
    b_t, s_t, i_t = tk.match_top2(torch.as_tensor(d0), torch.as_tensor(d1),
                                  torch.as_tensor(valid1))
    assert i_t.dtype == torch.int32
    np.testing.assert_allclose(b_t.numpy(), b_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-5, atol=1e-5)
    sep = (s_j - b_j) > 1e-4
    np.testing.assert_array_equal(i_t.numpy()[sep], i_j[sep])
    assert valid1[i_t.numpy()].all()


def test_top2_ties_and_duplicates():
    """A duplicated best row: lowest index wins and the duplicate is the
    second (distance equal to the best), as in the JAX kernel's spec."""
    d = np.eye(8, dtype=np.float32)
    d1 = np.concatenate([d[[3]], d, d[[3]]])  # rows 0, 4, 9 equal e3
    valid1 = np.ones(10, bool)
    valid1[0] = False
    b, s, i = tk._top2_torch(torch.as_tensor(d), torch.as_tensor(d1),
                             torch.as_tensor(valid1))
    assert int(i[3]) == 4 and float(b[3]) == 0.0 and float(s[3]) == 0.0
    b_j, s_j, i_j = _top2_jnp(jnp.asarray(d), jnp.asarray(d1), jnp.asarray(valid1))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-6)


@pytest.mark.parametrize("mutual", [False, True])
def test_match_descriptors_matches_jax(mutual):
    rng = np.random.default_rng(1)
    d0, d1, valid0, valid1 = _sets(rng)
    r_j = jmatch(jnp.asarray(d0), jnp.asarray(valid0), jnp.asarray(d1),
                 jnp.asarray(valid1), ratio=0.8, mutual=mutual, backend="jnp")
    r_t = tmatch(torch.as_tensor(d0), torch.as_tensor(valid0), torch.as_tensor(d1),
                 torch.as_tensor(valid1), ratio=0.8, mutual=mutual)
    ok_j = np.asarray(r_j.valid)
    np.testing.assert_array_equal(r_t.valid.numpy(), ok_j)
    np.testing.assert_array_equal(r_t.idx.numpy()[ok_j], np.asarray(r_j.idx)[ok_j])
    assert ok_j[:120].mean() > 0.8  # planted pairs are found


def test_ratio_outcomes_match_interpret_kernel():
    """bf16 cross term in the Pallas kernel vs float32 here: the accepted
    matches agree except within the kernel's ~1e-3 relative distance
    perturbation of the ratio threshold."""
    rng = np.random.default_rng(2)
    d0, d1, valid0, valid1 = _sets(rng, n0=256, n1=256)
    b_p, s_p, i_p = (np.asarray(x) for x in match_top2_pallas(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(valid1), interpret=True))
    r_t = tmatch(torch.as_tensor(d0), torch.as_tensor(valid0), torch.as_tensor(d1),
                 torch.as_tensor(valid1), ratio=0.8)
    ok_p = valid0 & (b_p < 0.64 * s_p)
    ok_t = r_t.valid.numpy()
    margin = np.abs(b_p - 0.64 * s_p) > 5e-3 * s_p
    np.testing.assert_array_equal(ok_t[margin], ok_p[margin])
    both = ok_t & ok_p
    np.testing.assert_array_equal(r_t.idx.numpy()[both], i_p[both])
