"""The port's pyramid (ops/pyramid.py) vs the JAX package on the CPU.

On the CPU `blur_stack` runs its plain version (the CUDA kernel is held
against that version on the card, tests/test_torch_kernels.py); the JAX
Pallas kernel runs in interpret mode, as in tests/test_pyramid.py. Inputs
come from numpy with a seed and go through both.

Tolerances: the plain version, the Pallas kernel and the band matmul sum
the same float32 taps in different orders, so they agree to a few 1e-7 on
inputs of O(1); the bounds below are the JAX tests' own (1e-5 against the
float64 oracle, 2e-5 for an octave, 1e-4 for a whole pyramid, where octave
seeds carry earlier round-off).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualodometry_tpu.ops import pyramid as jp
from visualodometry_tpu_torch.ops import pyramid as tp

torch.set_num_threads(2)


def _oracle_blur(img: np.ndarray, taps) -> np.ndarray:
    """Edge-padded separable convolution in float64, one channel."""
    t = np.asarray(taps, np.float64)
    r = (len(t) - 1) // 2
    x = np.pad(img.astype(np.float64), r, mode="edge")
    h = sum(t[i] * x[:, i : i + img.shape[1]] for i in range(len(t)))
    return sum(t[i] * h[i : i + img.shape[0], :] for i in range(len(t)))


def _image(shape, seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    return (0.5 * rng.random(shape) + 0.5 * np.sin(xx / 13.0) * np.cos(yy / 7.0)).astype(
        np.float32
    )


def test_stack_taps_equal_the_jax_ones():
    for scales, sigma0 in ((3, 1.6), (2, 1.2)):
        assert tp._stack_taps(scales, sigma0) == jp._stack_taps(scales, sigma0)


@pytest.mark.parametrize("shape", [(94, 201), (70, 130)])
def test_blur_stack_matches_pallas_interpret_and_oracle(shape):
    img = _image(shape)
    taps = tp._stack_taps(3, 1.6)
    out = tp.blur_stack(torch.as_tensor(img), taps).numpy()
    assert out.shape == (5, *shape)
    ref = np.asarray(jp.blur_stack_pallas(jnp.asarray(img), taps, interpret=True))
    assert np.abs(out - ref).max() <= 1e-5
    for c, k in enumerate(taps):
        assert np.abs(out[c] - _oracle_blur(img, k)).max() <= 1e-5


def test_blur_stack_batched_equals_per_frame():
    imgs = np.stack([_image((70, 130), seed=s) for s in range(3)])
    taps = tp._stack_taps(3, 1.6)
    batched = tp.blur_stack(torch.as_tensor(imgs), taps)
    assert batched.shape == (3, 5, 70, 130)
    for i in range(3):
        assert torch.equal(batched[i], tp.blur_stack(torch.as_tensor(imgs[i]), taps))
    two_lead = tp.blur_stack(torch.as_tensor(imgs[None]), taps)
    assert torch.equal(two_lead[0], batched)


def test_gaussian_octave_pallas_matches_jax():
    img = _image((94, 201))
    out = tp.build_gaussian_octave_pallas(torch.as_tensor(img), 1.6, 3).numpy()
    ref = np.asarray(jp.build_gaussian_octave(jnp.asarray(img), 1.6, 3))
    ref_k = np.asarray(
        jp.build_gaussian_octave_pallas(jnp.asarray(img), 1.6, 3, interpret=True)
    )
    assert out.shape == ref.shape == (6, 94, 201)
    assert np.abs(out - ref).max() <= 2e-5 and np.abs(out - ref_k).max() <= 2e-5


@pytest.mark.parametrize("shape", [(31, 47), (30, 64)])
def test_upsample_2x_matches_jax_resize(shape):
    """Half-pixel-centre bilinear with clamped edges on both sides; found
    to agree to 1.2e-7 at an odd and an even size, held to 1e-6."""
    img = _image(shape, seed=3)
    out = tp.upsample_2x(torch.as_tensor(img)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (2 * shape[0], 2 * shape[1]), "linear"))
    assert out.shape == ref.shape and np.abs(out - ref).max() <= 1e-6
    batched = tp.upsample_2x(torch.as_tensor(np.stack([img, img[::-1].copy()])))
    assert torch.equal(batched[0], torch.as_tensor(out))


@pytest.mark.parametrize("first_octave", [0, -1])
@pytest.mark.parametrize("impl", ["matmul", "pallas"])
def test_build_pyramid_matches_jax(impl, first_octave):
    img = _image((94, 201))
    jimpl = "pallas_interpret" if impl == "pallas" else "matmul"
    gauss_j, dogs_j = jp.build_pyramid(
        jnp.asarray(img), 3, 3, first_octave=first_octave, impl=jimpl
    )
    gauss, dogs = tp.build_pyramid(
        torch.as_tensor(img), 3, 3, first_octave=first_octave, impl=impl
    )
    assert len(gauss) == len(dogs) == 3
    for got, want in zip(gauss + dogs, list(gauss_j) + list(dogs_j)):
        assert tuple(got.shape) == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
    if first_octave == -1:
        assert tuple(gauss[0].shape) == (6, 188, 402)
    # a batch of frames gives each frame's pyramid
    g_b, _ = tp.build_pyramid(
        torch.as_tensor(np.stack([img, img[:, ::-1].copy()])), 3, 3,
        first_octave=first_octave, impl=impl,
    )
    for got, one in zip(g_b, gauss):
        assert float((got[0] - one).abs().max()) <= 1e-6


def test_auto_is_the_band_matmul():
    img = torch.as_tensor(_image((40, 60)))
    g_a, _ = tp.build_pyramid(img, 2, 3, impl="auto")
    g_m, _ = tp.build_pyramid(img, 2, 3, impl="matmul")
    assert all(torch.equal(a, m) for a, m in zip(g_a, g_m))
