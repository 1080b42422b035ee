"""Port patch gather (K2's plain version) vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode, as tests/test_patches.py runs it,
with inputs that meet its Mosaic constraints (W % 128 == 0, y0 % 8 == 0,
K % 8 == 0). The window gather is pure data movement, so the outputs must
be bit-equal; so must the bitcast (gx, gy) bf16 gradient packing.
K2 itself runs only on the card: tests/test_torch_kernels.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualodometry_tpu.frontend import sift as jsift
from visualodometry_tpu.ops.patches import extract_patches as jextract
from visualodometry_tpu_torch.frontend import sift as tsift
from visualodometry_tpu_torch.ops import patches as tp

torch.set_num_threads(2)


def _inputs(rng, L=3, H=48, W=256, K=16, Py=24, Px=16, aligned_y=True):
    field = rng.integers(-(2**31), 2**31 - 1, (L, H, W), dtype=np.int64).astype(np.int32)
    lvl = rng.integers(0, L, K).astype(np.int32)
    y0 = rng.integers(0, H - Py + 1, K).astype(np.int32)
    if aligned_y:
        y0 &= ~7
    x0 = rng.integers(0, W - Px + 1, K).astype(np.int32)
    x0[:2] = [0, W - Px]  # both edges
    return field, lvl, y0, x0


def test_plain_gather_matches_interpret_kernel():
    rng = np.random.default_rng(0)
    field, lvl, y0, x0 = _inputs(rng)
    want = np.asarray(jextract(
        jnp.asarray(field), jnp.asarray(lvl), jnp.asarray(y0), jnp.asarray(x0),
        patch_y=24, patch_x=16, interpret=True,
    ))
    got = tp.extract_patches(*(torch.as_tensor(a) for a in (field, lvl, y0, x0)), 24, 16)
    assert got.dtype == torch.int32 and got.shape == (16, 24, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_any_in_bounds_origin_and_shape():
    """No Mosaic constraints: odd origins, W not a multiple of 128."""
    rng = np.random.default_rng(1)
    field, lvl, y0, x0 = _inputs(rng, L=2, H=37, W=53, K=5, Py=9, Px=7, aligned_y=False)
    got = tp.extract_patches(*(torch.as_tensor(a) for a in (field, lvl, y0, x0)), 9, 7)
    for k in range(5):
        np.testing.assert_array_equal(
            got[k].numpy(), field[lvl[k], y0[k] : y0[k] + 9, x0[k] : x0[k] + 7]
        )


@pytest.mark.parametrize("which", ["lvl", "y0", "x0", "negative"])
def test_out_of_bounds_origin_raises(which):
    rng = np.random.default_rng(2)
    field, lvl, y0, x0 = _inputs(rng, K=8)
    if which == "lvl":
        lvl[3] = field.shape[0]
    elif which == "y0":
        y0[3] = field.shape[1] - 24 + 1
    elif which == "x0":
        x0[3] = field.shape[2] - 16 + 1
    else:
        x0[3] = -1
    with pytest.raises(IndexError):
        tp.extract_patches(*(torch.as_tensor(a) for a in (field, lvl, y0, x0)), 24, 16)


def test_gradient_packing_bit_identical():
    """The int32 field K2 copies from carries the same bits as JAX's, and
    unpacking reads gx / gy back from the right halves."""
    rng = np.random.default_rng(3)
    gauss = rng.random((4, 30, 50)).astype(np.float32)
    f_j = np.asarray(jsift._pack_gradients_planar(jnp.asarray(gauss), 32, 128))
    f_t = tsift._pack_gradients_planar(torch.as_tensor(gauss), 32, 128)
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    p_j = jsift._unpack_patches(jnp.asarray(f_j[:, :24, :16]))
    p_t = tsift._unpack_patches(f_t[:, :24, :16].contiguous())
    np.testing.assert_array_equal(
        p_t.to(torch.float32).numpy(), np.asarray(p_j.astype(jnp.float32))
    )
    gx, gy = tsift._gradients(torch.as_tensor(gauss))
    np.testing.assert_array_equal(
        p_t[:, 0].to(torch.float32).numpy(),
        gx[:, :24, :16].to(torch.bfloat16).to(torch.float32).numpy(),
    )
