"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has a GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest` because tests/conftest.py sets JAX up.) Here, without a
card, the `cuda` tests skip; the wrapper checks and the dispatch of CPU
tensors to the plain versions run everywhere.
"""

import numpy as np
import pytest
import torch

from visualodometry_tpu_torch.ops import _build
from visualodometry_tpu_torch.ops import match_top2 as mt
from visualodometry_tpu_torch.ops import patches as pt
from visualodometry_tpu_torch.ops import pyramid as py


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _descriptors(rng, n0, n1, d, invalid=0.1):
    d0 = rng.normal(size=(n0, d)).astype(np.float32)
    d1 = rng.normal(size=(n1, d)).astype(np.float32)
    k = min(n0, n1) // 2
    d1[:k] = d0[:k] + 0.05 * rng.normal(size=(k, d))
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    return d0, d1, rng.random(n1) >= invalid


def test_kernel_sources_and_build_names():
    for name in _build.KERNEL_SOURCES:
        src = _build.CSRC / f"{name}.cu"
        assert src.exists()
        assert "extern \"C\"" in src.read_text()
        assert _build._lib_path(name).parent == _build.BUILD_DIR
        assert _build._lib_path(name).name.startswith(name + "-")


def test_match_top2_checks_inputs():
    d = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        mt.match_top2(d.double(), d.double(), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        mt.match_top2(d, torch.zeros(4, 16), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        mt.match_top2(d, d, torch.ones(5, dtype=torch.bool))


def test_match_top2_rejects_zero_depth():
    d = torch.zeros(4, 0)
    with pytest.raises(ValueError, match="depth"):
        mt.match_top2(d, d, torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize(
    "n0,n1,sms,want",
    [
        (4096, 4096, 132, 4),  # the main path: 32 query tiles x 4 splits
        (2048, 4096, 132, 8),
        (4096, 4096 - 37, 132, 4),
        (33, 5, 132, 1),  # one train tile: never an empty split
        (64, 300, 132, 3),
        (100, 100000, 132, 32),  # capped
        (40000, 4096, 132, 1),  # more query tiles than SMs
        (0, 0, 132, 1),
    ],
)
def test_match_top2_splits(n0, n1, sms, want):
    """The train-set split the wrapper hands the kernel: query tiles x
    splits fills the SMs once, no split is empty, the scratch stays small."""
    s = mt._splits(n0, n1, sms)
    assert s == want
    assert 1 <= s <= mt.MAX_SPLITS and s <= max(1, -(-n1 // 128))


def test_match_top2_splits_rejects_bad_sizes():
    with pytest.raises(ValueError):
        mt._splits(-1, 10, 132)
    with pytest.raises(ValueError):
        mt._splits(10, 10, 0)


def test_extract_patches_checks_inputs():
    field = torch.zeros(2, 16, 16, dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        pt.extract_patches(field.float(), idx, idx, idx, 4, 4)
    with pytest.raises(TypeError):
        pt.extract_patches(field, idx.long(), idx, idx, 4, 4)
    with pytest.raises(ValueError):
        pt.extract_patches(field, idx, idx, idx, 17, 4)


def test_blur_stack_checks_inputs():
    img = torch.zeros(8, 8)
    with pytest.raises(TypeError):
        py.blur_stack(img.double(), ((0.25, 0.5, 0.25),))
    with pytest.raises(ValueError):
        py.blur_stack(img, ((0.5, 0.5),))
    with pytest.raises(ValueError):
        py.build_pyramid(img, 1, 3, impl="conv")
    with pytest.raises(ValueError):
        py.build_pyramid(img, 1, 3, first_octave=1)


def test_cpu_tensors_take_the_plain_versions():
    """No launch is counted for CPU tensors: they never reach a kernel."""
    rng = np.random.default_rng(0)
    before = (mt.launches, pt.launches, py.launches)
    d0, d1, v1 = _descriptors(rng, 16, 24, 8)
    out = mt.match_top2(torch.as_tensor(d0), torch.as_tensor(d1), torch.as_tensor(v1))
    ref = mt._top2_torch(torch.as_tensor(d0), torch.as_tensor(d1), torch.as_tensor(v1))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    field = torch.arange(2 * 10 * 12, dtype=torch.int32).reshape(2, 10, 12)
    k = torch.tensor([1, 0], dtype=torch.int32)
    p = pt.extract_patches(field, k, torch.tensor([2, 6], dtype=torch.int32),
                           torch.tensor([3, 8], dtype=torch.int32), 4, 4)
    assert torch.equal(p[0], field[1, 2:6, 3:7]) and torch.equal(p[1], field[0, 6:10, 8:12])
    img = torch.as_tensor(rng.random((2, 20, 33)).astype(np.float32))
    taps = py._stack_taps(3, 1.6)
    stack = py.blur_stack(img, taps)
    assert torch.equal(stack, py._blur_stack_torch(img, torch.tensor(taps)))
    assert (mt.launches, pt.launches, py.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n0,n1,d,invalid",
    [(1000, 777, 128, 0.1), (33, 5, 64, 0.0), (64, 300, 256, 0.5), (40, 50, 128, 1.0),
     (300, 1000, 8, 0.1), (300, 1000, 100, 0.1), (130, 700, 6, 0.0), (200, 900, 320, 0.1),
     (4096, 4096 - 37, 128, 0.1)],
)
def test_match_top2_kernel_matches_plain(cuda_device, n0, n1, d, invalid):
    """Ragged tiles and splits, other depths (a streamed query tile above
    d=128; zero-padded depths 8, 100 and, unaligned, 6), and an all-invalid
    train set (every distance 1e30, index 0)."""
    rng = np.random.default_rng(n0 + n1)
    d0, d1, v1 = _descriptors(rng, n0, n1, d, invalid)
    a = [torch.as_tensor(x, device=cuda_device) for x in (d0, d1, v1)]
    before = mt.launches
    b_k, s_k, i_k = mt.match_top2(*a)
    assert mt.launches == before + 1
    b_p, s_p, i_p = mt._top2_torch(*a)
    torch.cuda.synchronize()
    torch.testing.assert_close(b_k, b_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-5)
    sep = (s_p - b_p) > 1e-4
    assert torch.equal(i_k[sep], i_p[sep])


@pytest.mark.cuda
def test_match_top2_ties_on_card(cuda_device):
    d = torch.eye(8, device=cuda_device)
    d1 = torch.cat([d[[3]], d, d[[3]]])
    v1 = torch.ones(10, dtype=torch.bool, device=cuda_device)
    v1[0] = False
    b, s, i = mt.match_top2(d, d1, v1)
    assert int(i[3]) == 4 and float(b[3]) == 0.0 and float(s[3]) == 0.0


@pytest.mark.cuda
def test_match_top2_duplicate_rows_in_different_splits(cuda_device):
    """A train row and its copy in another split: the lower index wins and
    the copy's distance is the second; with the first made invalid, the copy
    wins. Exact, because equal rows give equal sums in every block."""
    rng = np.random.default_rng(11)
    d0, d1, _ = _descriptors(rng, 256, 1024, 128, 0.0)
    assert mt._splits(256, 1024, 132) == 8  # 128 train rows a split
    d1[70] = d0[5]
    d1[900] = d0[5]  # split 0 and split 7
    d1[300] = d1[650]  # splits 2 and 5, not the best of any query
    a0, a1 = (torch.as_tensor(x, device=cuda_device) for x in (d0, d1))
    v1 = torch.ones(1024, dtype=torch.bool, device=cuda_device)
    b, s, i = mt.match_top2(a0, a1, v1)
    b_p, s_p, i_p = mt._top2_torch(a0, a1, v1)
    assert int(i[5]) == 70 and float(s[5]) == float(b[5])
    assert float(b[5]) <= 5e-6
    sep = (s_p - b_p) > 1e-4
    sep[5] = False
    assert torch.equal(i[sep], i_p[sep])
    v1[70] = False
    b, s, i = mt.match_top2(a0, a1, v1)
    assert int(i[5]) == 900 and float(s[5]) > float(b[5])
    # the same distance from two splits for every query: second == best
    # only where that row is the best, and then the lower index is kept
    q = a1[[300]].clone()
    b, s, i = mt.match_top2(q, a1, torch.ones_like(v1))
    assert int(i[0]) == 300 and float(s[0]) == float(b[0])


@pytest.mark.cuda
def test_match_top2_empty_query_set(cuda_device):
    d0 = torch.zeros(0, 16, device=cuda_device)
    d1 = torch.ones(10, 16, device=cuda_device)
    b, s, i = mt.match_top2(d0, d1, torch.ones(10, dtype=torch.bool, device=cuda_device))
    assert b.shape == s.shape == i.shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("W,px", [(256, 16), (53, 16), (256, 7), (130, 16)])
def test_extract_patches_kernel_matches_plain(cuda_device, W, px):
    """The TMA path (W, px multiples of 4; any x0) and the scalar path."""
    rng = np.random.default_rng(W + px)
    L, H, K, py = 3, 48, 40, 24
    field = torch.as_tensor(
        rng.integers(-(2**31), 2**31 - 1, (L, H, W), dtype=np.int64).astype(np.int32),
        device=cuda_device,
    )
    lvl = torch.as_tensor(rng.integers(0, L, K).astype(np.int32), device=cuda_device)
    y0 = torch.as_tensor(rng.integers(0, H - py + 1, K).astype(np.int32), device=cuda_device)
    x0 = torch.as_tensor(rng.integers(0, W - px + 1, K).astype(np.int32), device=cuda_device)
    before = pt.launches
    out = pt.extract_patches(field, lvl, y0, x0, py, px)
    assert pt.launches == before + 1
    assert torch.equal(out, pt._extract_patches_torch(field, lvl, y0, x0, py, px))
    x0[0] = W - px + 1
    with pytest.raises(IndexError):
        pt.extract_patches(field, lvl, y0, x0, py, px)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_extract_patches_tma_any_x0_alignment(cuda_device, shift):
    """Every residue of x0 modulo 4 words at the main path's window, more
    keypoints than one round of the ring, and the field's corners."""
    rng = np.random.default_rng(shift)
    L, H, W, K, py, px = 6, 96, 384, 1500, 72, 64
    field = torch.as_tensor(
        rng.integers(-(2**31), 2**31 - 1, (L, H, W), dtype=np.int64).astype(np.int32),
        device=cuda_device,
    )
    lvl = rng.integers(0, L, K).astype(np.int32)
    y0 = rng.integers(0, H - py + 1, K).astype(np.int32)
    x0 = (rng.integers(0, (W - px) // 4, K) * 4 + shift).astype(np.int32)
    lvl[:4], y0[:4], x0[:4] = (0, 0, L - 1, L - 1), (0, H - py, 0, H - py), (shift, W - px, 0, W - px)
    lvl, y0, x0 = (torch.as_tensor(a, device=cuda_device) for a in (lvl, y0, x0))
    out = pt.extract_patches(field, lvl, y0, x0, py, px)
    assert torch.equal(out, pt._extract_patches_torch(field, lvl, y0, x0, py, px))


@pytest.mark.cuda
def test_extract_patches_float_image_bitcast(cuda_device):
    """Float32 pixels bitcast to int32 words come back bit-equal: the copy
    assumes nothing about what a word holds (NaN and -0.0 included)."""
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 64, 128)).astype(np.float32)
    img[0, 3, 5], img[1, 10, 20], img[1, 11, 21] = np.nan, -0.0, np.inf
    img = torch.as_tensor(img, device=cuda_device)
    K, py, px = 77, 16, 16
    lvl = torch.as_tensor(rng.integers(0, 2, K).astype(np.int32), device=cuda_device)
    y0 = torch.as_tensor(rng.integers(0, 64 - py + 1, K).astype(np.int32), device=cuda_device)
    x0 = torch.as_tensor(rng.integers(0, 128 - px + 1, K).astype(np.int32), device=cuda_device)
    y0[0], x0[0], lvl[0] = 0, 0, 0
    out = pt.extract_patches(img.view(torch.int32), lvl, y0, x0, py, px)
    ref = pt._extract_patches_torch(img.view(torch.int32), lvl, y0, x0, py, px)
    assert torch.equal(out, ref)
    patches = out.view(torch.float32)
    assert torch.isnan(patches[0, 3, 5]) and bool(torch.isfinite(patches[0, 0, 0]))


@pytest.mark.cuda
def test_extract_patches_adds_no_sync(cuda_device):
    """Encoding the tensor map is host arithmetic: with `check_bounds=False`
    a call makes no device synchronisation."""
    field = torch.zeros(2, 96, 384, dtype=torch.int32, device=cuda_device)
    z = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    pt.extract_patches(field, z, z, z, 72, 64, check_bounds=False)  # builds, loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pt.extract_patches(field, z, z, z, 72, 64, check_bounds=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# (B, C, H, W): the octave and base shapes of the 1226 x 370 paths (first
# octave -1 and 0), and a ragged one
BLUR_SHAPES = [
    (8, 5, 740, 2452), (8, 5, 370, 1226), (8, 5, 185, 613), (8, 5, 93, 307),
    (8, 5, 47, 154), (8, 1, 740, 2452), (8, 1, 370, 1226), (3, 5, 70, 130),
]


def _blur_taps(C, upsampled=True):
    if C > 1:
        return py._stack_taps(3, 1.6)
    sig = (1.6**2 - (1.0 if upsampled else 0.5) ** 2) ** 0.5
    return (tuple(py._full_kernel_np(sig, int(np.ceil(3.0 * sig))).tolist()),)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,W", BLUR_SHAPES)
def test_blur_stack_kernel_matches_plain(cuda_device, B, C, H, W):
    """1e-5 on inputs in [0, 1]: the kernel fuses each multiply-add, the
    plain version rounds twice; both sum in tap order."""
    rng = np.random.default_rng(H + W)
    img = torch.as_tensor(rng.random((B, H, W)).astype(np.float32), device=cuda_device)
    taps = _blur_taps(C, upsampled=(H == 740))
    before = py.launches
    out = py.blur_stack(img, taps)
    assert py.launches == before + 1 and out.shape == (B, C, H, W)
    ref = py._blur_stack_torch(img, torch.tensor(taps, device=cuda_device))
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5
    # a frame's stack does not depend on the batch it is computed in
    assert torch.equal(py.blur_stack(img[1], taps), out[1])


@pytest.mark.cuda
def test_blur_stack_other_radii_on_card(cuda_device):
    """Tap counts that are and are not multiples of the kernel's step,
    and a radius whose tile needs more than 48 KB of shared memory."""
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.random((2, 50, 90)).astype(np.float32), device=cuda_device)
    for radius in (1, 2, 6, 30):
        taps = (tuple(py._full_kernel_np(radius / 3.0, radius).tolist()),) * 2
        ref = py._blur_stack_torch(img, torch.tensor(taps, device=cuda_device))
        assert float((py.blur_stack(img, taps) - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_pyramid_pallas_launches_kernel_for_every_octave(cuda_device):
    rng = np.random.default_rng(4)
    img = torch.as_tensor(rng.random((2, 94, 201)).astype(np.float32), device=cuda_device)
    py.launches = 0
    g_k, _ = py.build_pyramid(img, 3, 3, first_octave=-1, impl="pallas")
    assert py.launches == 1 + 3
    g_m, _ = py.build_pyramid(img, 3, 3, first_octave=-1, impl="matmul")
    assert py.launches == 1 + 3
    for a, b in zip(g_k, g_m):
        assert float((a - b).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_pyramid_pallas_raises_without_its_library(cuda_device, monkeypatch):
    """No fallback to the band matmul or the plain version on CUDA."""

    def no_library(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(_build, "load_library", no_library)
    img = torch.zeros(2, 40, 60, device=cuda_device)
    with pytest.raises(RuntimeError, match="cannot load blur_stack"):
        py.build_pyramid(img, 2, 3, impl="pallas")
