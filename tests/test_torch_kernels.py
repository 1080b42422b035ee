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
from visualodometry_tpu_torch.ops import small_eig as se


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


def test_entry_point_signatures_match_the_sources():
    """Every `extern "C"` function of csrc/ is declared in ENTRY_POINTS with
    one ctypes type a parameter, in order: a pointer as c_void_p, an int as
    c_int, a float as c_float."""
    import ctypes
    import re

    kinds = {"*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    assert set(_build.ENTRY_POINTS) == set(_build.KERNEL_SOURCES)
    for name, declared in _build.ENTRY_POINTS.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
        assert set(found) == set(declared), name
        for symbol, params in found.items():
            types = [kinds["*" if "*" in p else p.split()[0]] for p in params.split(",")]
            assert types == declared[symbol], symbol
    with pytest.raises(KeyError):
        _build.c_function("patches", "match_top2_launch")


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
     (4096, 4096 - 37, 128, 0.1), (2048, 2048, 256, 0.1)],
)
def test_match_top2_kernel_matches_plain(cuda_device, n0, n1, d, invalid):
    """Ragged tiles and splits, other depths (a streamed query tile above
    d=128; zero-padded depths 8, 100 and, unaligned, 6), an all-invalid
    train set (every distance 1e30, index 0), and the SuperPoint path's
    shape (2048 x 2048 x 256)."""
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
@pytest.mark.parametrize(
    "B,n0,n1,d", [(4, 4096, 4096, 128), (3, 1000, 777, 128), (2, 64, 300, 256), (5, 33, 5, 64)]
)
def test_match_top2_lanes_match_plain_and_2d(cuda_device, B, n0, n1, d):
    """B lanes in one launch: each lane within the 2-D test's tolerances of
    the plain version, and bit-equal to its own 2-D launch (a distance does
    not depend on the split count, and the merge keeps the lowest index)."""
    rng = np.random.default_rng(B * n0 + n1)
    sets = [_descriptors(rng, n0, n1, d, 0.1) for _ in range(B)]
    a = [torch.as_tensor(np.stack(x), device=cuda_device) for x in zip(*sets)]
    before = mt.launches
    b_k, s_k, i_k = mt.match_top2(*a)
    assert mt.launches == before + 1 and b_k.shape == (B, n0)
    b_p, s_p, i_p = mt._top2_torch(*a)
    torch.cuda.synchronize()
    torch.testing.assert_close(b_k, b_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-5)
    sep = (s_p - b_p) > 1e-4
    assert torch.equal(i_k[sep], i_p[sep])
    for lane in range(B):
        one = mt.match_top2(a[0][lane], a[1][lane], a[2][lane])
        for x, y in zip((b_k[lane], s_k[lane], i_k[lane]), one):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_match_top2_one_lane_is_the_2d_launch(cuda_device):
    rng = np.random.default_rng(7)
    a = [torch.as_tensor(x, device=cuda_device) for x in _descriptors(rng, 4096, 4096, 128)]
    two_d = mt.match_top2(*a)
    one_lane = mt.match_top2(*(x[None] for x in a))
    for x, y in zip(two_d, one_lane):
        assert torch.equal(x, y[0])


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
@pytest.mark.parametrize("L, H, W, py, px, K", [
    (2, 64, 128, 16, 16, 77),
    # KLT mode's windows (ops/klt.py): the 24 x 16 template and the 40 x 32
    # next-frame window on level 0's field at 1226 x 370, 4096 slots
    (1, 376, 1280, 24, 16, 4096),
    (1, 376, 1280, 40, 32, 4096),
])
def test_extract_patches_float_image_bitcast(cuda_device, L, H, W, py, px, K):
    """Float32 pixels bitcast to int32 words come back bit-equal: the copy
    assumes nothing about what a word holds (NaN and -0.0 included). The
    KLT shapes take the TMA kernel, not the scalar loop."""
    rng = np.random.default_rng(5)
    img = rng.standard_normal((L, H, W)).astype(np.float32)
    img[0, 3, 5], img[-1, 10, 20], img[-1, 11, 21] = np.nan, -0.0, np.inf
    img = torch.as_tensor(img, device=cuda_device)
    lvl = torch.as_tensor(rng.integers(0, L, K).astype(np.int32), device=cuda_device)
    y0 = torch.as_tensor(rng.integers(0, H - py + 1, K).astype(np.int32), device=cuda_device)
    x0 = torch.as_tensor(rng.integers(0, W - px + 1, K).astype(np.int32), device=cuda_device)
    y0[0], x0[0], lvl[0] = 0, 0, 0
    tma0 = pt.routes["tma"]
    out = pt.extract_patches(img.view(torch.int32), lvl, y0, x0, py, px)
    ref = pt._extract_patches_torch(img.view(torch.int32), lvl, y0, x0, py, px)
    assert torch.equal(out, ref)
    assert pt.routes["tma"] == tma0 + 1
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
# octave -1 and 0), a ragged one, the most channels the pyramid gives (C = 8,
# sift_scales_per_octave=6) at a row pitch that is not 16-byte aligned, a
# height that is not a multiple of the 128- or 64-row tile at W = 1226
# (pitch not 16-byte aligned either), and images smaller than the halo
BLUR_SHAPES = [
    (8, 5, 740, 2452), (8, 5, 370, 1226), (8, 5, 185, 613), (8, 5, 93, 307),
    (8, 5, 47, 154), (8, 1, 740, 2452), (8, 1, 370, 1226), (3, 5, 70, 130),
    (2, 8, 70, 153), (2, 5, 200, 1226), (3, 5, 3, 5), (2, 1, 3, 5),
]


def _blur_taps(C, upsampled=True):
    if C > 1:
        return py._stack_taps(C - 2, 1.6)  # C = scales + 2
    sig = (1.6**2 - (1.0 if upsampled else 0.5) ** 2) ** 0.5
    return (tuple(py._full_kernel_np(sig, int(np.ceil(3.0 * sig))).tolist()),)


def _radius_taps(radius, C):
    """C Gaussian tap rows of one radius, each of another sigma."""
    return tuple(
        tuple(py._full_kernel_np(radius / 3.0 * (1 + 0.1 * c), radius).tolist())
        for c in range(C)
    )


def test_blur_stack_rejects_radius_above_64():
    """The JAX kernel asserts radius <= 64; the wrapper raises on every device."""
    img = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="radius"):
        py.blur_stack(img, _radius_taps(65, 2))
    assert py.blur_stack(img, _radius_taps(64, 2)).shape == (2, 2, 8, 8)
    with pytest.raises(ValueError):
        py.blur_stack(img, ((0.25, 0.5, 0.25), (1.0,)))  # rows of two lengths
    with pytest.raises(ValueError):
        py.blur_stack(img, ())


@pytest.mark.parametrize(
    "taps,C,TP,RA",
    [
        (py._stack_taps(3, 1.6), 5, 32, 16),  # the octave stack: 31 taps, R = 15
        (_blur_taps(1, upsampled=True), 1, 12, 4),  # base pre-blur, 9 taps
        (_blur_taps(1, upsampled=False), 1, 16, 8),  # first octave 0: 11 taps
        (py._stack_taps(1, 1.6), 3, 80, 40),  # sift_scales_per_octave=1: R = 39
        (py._stack_taps(6, 1.6), 8, 32, 12),  # sift_scales_per_octave=6: R = 12
        (_radius_taps(64, 2), 2, 132, 64),
        (_radius_taps(1, 2), 2, 8, 4),
        (((0.0,) * 3 + (1.0,) + (0.0,) * 3,), 1, 8, 4),  # R = 3: one leading zero
    ],
)
def test_blur_stack_tap_packing(taps, C, TP, RA):
    """The taps the launcher receives by value: float32, (C, TP) in channel
    order, each row after (-R) mod 4 leading zeros and zero-padded to TP, one
    of the padded counts the kernel is built for; RA = R + the leading zeros,
    a multiple of 4."""
    packed, ra = py._pack_taps(taps)
    T = len(taps[0])
    R = (T - 1) // 2
    lead = ra - R
    assert packed.dtype == np.float32 and packed.flags["C_CONTIGUOUS"]
    assert packed.shape == (C, TP) and TP in py.TAP_COUNTS and ra == RA
    assert ra % 4 == 0 and 0 <= lead < 4 and lead + T <= TP
    assert not packed[:, :lead].any() and not packed[:, lead + T :].any()
    np.testing.assert_array_equal(packed[:, lead : lead + T], np.asarray(taps, np.float32))
    # the smallest padded count that holds the row
    assert all(n < lead + T for n in py.TAP_COUNTS if n < TP)


def _blur_stack_padded(bases, packed, RA):
    """The plain version's two tap-order sums over the packed taps: tap t of a
    row reads offset t - RA, as the kernel does."""
    C, TP = packed.shape
    B, H, W = bases.shape
    w = torch.as_tensor(packed).reshape(1, C, 1, 1, TP)
    pad = TP - 1 - RA  # the far side: taps past the row's end
    x = torch.nn.functional.pad(bases[:, None], (RA, pad, RA, pad), mode="replicate")
    h = w[..., 0] * x[..., 0:W]
    for t in range(1, TP):
        h = h + w[..., t] * x[..., t : t + W]
    out = w[..., 0] * h[:, :, 0:H]
    for t in range(1, TP):
        out = out + w[..., t] * h[:, :, t : t + H]
    return out


@pytest.mark.parametrize("C", [1, 3, 5, 8])
def test_blur_stack_padded_taps_give_the_same_bits(C):
    """The zeros the packing adds, leading and trailing, change no bit of a
    tap-order sum that starts from the first product: the plain version's
    sums over the packed taps equal its sums over the taps as given."""
    rng = np.random.default_rng(C)
    img = torch.as_tensor(rng.random((2, 21, 37)).astype(np.float32))
    taps = _blur_taps(C, upsampled=False)
    packed, RA = py._pack_taps(taps)
    want = py._blur_stack_torch(img, torch.tensor(taps))
    assert torch.equal(_blur_stack_padded(img, packed, RA), want)


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
@pytest.mark.parametrize(
    "radius,C", [(1, 2), (2, 2), (6, 2), (30, 2), (64, 2), (39, 3), (12, 8), (19, 4)]
)
def test_blur_stack_other_radii_on_card(cuda_device, radius, C):
    """Tap counts that are and are not multiples of the kernel's step, the
    largest radius (64), and the radii sift_scales_per_octave 1, 2 and 6
    give, at a height that is no multiple of any tile and a row pitch that is
    not 16-byte aligned."""
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.random((2, 150, 90)).astype(np.float32), device=cuda_device)
    taps = _radius_taps(radius, C)
    ref = py._blur_stack_torch(img, torch.tensor(taps, device=cuda_device))
    assert float((py.blur_stack(img, taps) - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_blur_stack_instantiations(cuda_device):
    """The pyramid's pairs run instantiations of their own; other C take the
    generic one; more than 8 channels raise on CUDA (the CPU takes any)."""
    assert py.blur_stack_instantiation(py._stack_taps(3, 1.6)) == "specialised"
    assert py.blur_stack_instantiation(_blur_taps(1, upsampled=True)) == "specialised"
    assert py.blur_stack_instantiation(_blur_taps(1, upsampled=False)) == "specialised"
    assert py.blur_stack_instantiation(py._stack_taps(1, 1.6)) == "generic"
    assert py.blur_stack_instantiation(_radius_taps(64, 2)) == "generic"
    img = torch.zeros(1, 16, 16, device=cuda_device)
    with pytest.raises(ValueError, match="channels"):
        py.blur_stack(img, _radius_taps(3, 9))
    with pytest.raises(ValueError, match="radius"):
        py.blur_stack(img, _radius_taps(65, 2))
    assert py.blur_stack(img.cpu(), _radius_taps(3, 9)).shape == (1, 9, 16, 16)


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


def _float64(batch):
    if isinstance(batch, torch.Tensor):
        return batch.double() if batch.is_floating_point() else batch
    return type(batch)(*(_float64(x) for x in batch))


@pytest.mark.cuda
def test_dense_train_step_on_card_matches_cpu(cuda_device):
    """`make_train_step_dense` on the card (2 VO pairs of 64x96, a tiny pool
    of the port's SIFT-teacher labels) against the same loss in float64 on
    the CPU, from the same weights: the loss and its terms within 1e-5
    relative; the gradient within 1e-4 of each parameter's largest entry
    with cuDNN off (the port's operators on the card: measured 1.8e-6 on an
    H100 80GB HBM3) and within 5e-3 with cuDNN on (its float32 convolution
    algorithms at this shape: measured 2.8e-3 in every cuDNN mode, where
    the CPU's float32 is 1.8e-6 and TF32 is off); Adam's first moment 0.1 x
    that gradient. Parameters after the step are not compared: Adam's
    first step is lr x sign(g). Prints the three distances (run with -s)."""
    from visualodometry_tpu_torch.models import train_superpoint_dense as td
    from visualodometry_tpu_torch.models import vo_distill as vd
    from visualodometry_tpu_torch.models.optim import Adam, cosine_decay_schedule
    from visualodometry_tpu_torch.models.superpoint import SuperPointDense
    from visualodometry_tpu_torch.models.train_superpoint import batch_to

    pool = vd.build_vo_pool(np.random.default_rng(3), n_scenes=1, frames_per_scene=3,
                            render_size=(160, 120), sift_slots=128, device="cpu")
    batch = vd.vo_pair_batch(np.random.default_rng(4), pool, batch=2, hw=(64, 96))
    init = SuperPointDense()
    init.init_random(torch.Generator().manual_seed(0))

    def model_on(dev, dtype=torch.float32):
        model = SuperPointDense()
        model.load_state_dict(init.state_dict())
        return model.to(dev, dtype)

    def loss_and_grads(dev, dtype=torch.float32):
        model = model_on(dev, dtype)
        b = batch_to(batch, dev)
        loss, aux = td.loss_fn_dense(model, _float64(b) if dtype == torch.float64 else b)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return [loss.item(), *(a.item() for a in aux)], [g.double().cpu().numpy() for g in grads]

    def worst(grads, ref):
        return max(np.abs(g - r).max() / np.abs(r).max() for g, r in zip(grads, ref))

    terms_ref, ref = loss_and_grads("cpu", torch.float64)
    enabled = torch.backends.cudnn.enabled
    try:
        torch.backends.cudnn.enabled = False
        _, plain = loss_and_grads(cuda_device)
    finally:
        torch.backends.cudnn.enabled = enabled
    terms, grads = loss_and_grads(cuda_device)
    _, cpu = loss_and_grads("cpu")
    print(f"dense step gradient from float64, of each parameter's largest entry: cuDNN on "
          f"{worst(grads, ref):.3e}, cuDNN off {worst(plain, ref):.3e}, CPU float32 "
          f"{worst(cpu, ref):.3e}")
    np.testing.assert_allclose(terms, terms_ref, rtol=1e-5)
    assert worst(plain, ref) <= 1e-4
    assert worst(grads, ref) <= 5e-3

    model = model_on(cuda_device)
    opt = Adam(model.parameters(), cosine_decay_schedule(2e-4, 10, alpha=0.05))
    loss, _ = td.make_train_step_dense(model, opt)(batch)
    np.testing.assert_allclose(loss.item(), terms[0], rtol=1e-6)
    for m, g in zip(opt.exp_avg, grads):
        assert np.abs(m.double().cpu().numpy() - 0.1 * g).max() <= 1e-6 * np.abs(g).max()


@pytest.mark.cuda
@pytest.mark.parametrize("rows, dtype", [((), torch.int32), ((3,), torch.float32)])
def test_scatter_drop_repeats_on_card(cuda_device, rows, dtype):
    """`core/state.scatter_drop` with many repeated indices at 4096 slots,
    20 times on the card: every result bit-equal to the CPU's, which keeps
    the last of repeated entries (tests/test_torch_scatter.py holds the CPU
    against JAX's drop-scatter)."""
    from visualodometry_tpu_torch.core.state import scatter_drop

    n = 4096
    g = torch.Generator().manual_seed(1)
    dst = torch.randint(-1, 1 << 20, (n,) + rows, generator=g).to(dtype)
    src = torch.randint(-1, 1 << 20, (n,) + rows, generator=g).to(dtype)
    idx = torch.randint(0, n // 8 + 1, (n,), generator=g, dtype=torch.int32)
    idx[torch.rand(n, generator=g) < 0.2] = n
    want = scatter_drop(dst, idx, src)
    d, i, s = dst.to(cuda_device), idx.to(cuda_device), src.to(cuda_device)
    for _ in range(20):
        assert torch.equal(scatter_drop(d, i, s).cpu(), want)


def _normal_matrices(rng, batch, n, rank):
    """A^T A of `rank` unit rows of width n, as the DLT and triangulation
    build them (pnp.py, triangulation.py): rank-deficient normal matrices,
    float32, shape batch + (n, n)."""
    A = rng.normal(size=tuple(batch) + (rank, n))
    A /= np.linalg.norm(A, axis=-1, keepdims=True)
    return torch.as_tensor((np.swapaxes(A, -1, -2) @ A).astype(np.float32))


def test_small_eig_source_is_built():
    assert "small_eig" in _build.KERNEL_SOURCES
    assert "extern \"C\" int small_eig_launch" in (_build.CSRC / "small_eig.cu").read_text()


@pytest.mark.parametrize("batch, n", [((5,), 4), ((3,), 9), ((2, 3), 12), ((1,), 16)])
def test_small_eig_cpu_takes_the_plain_version(batch, n):
    """`linalg.smallest_eigvec` on a CPU tensor is the plain version bit for
    bit; no launch is counted, in the module or in the program's recorder."""
    from visualodometry_tpu_torch.geometry import linalg
    from visualodometry_tpu_torch.utils import profiling

    M = _normal_matrices(np.random.default_rng(n), batch, n, n - 1)
    before = se.launches
    profiling.reset()
    profiling.enable(True)
    try:
        v = linalg.smallest_eigvec(M)
        counted = profiling.summary()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert torch.equal(v, se._smallest_eigvec_torch(M))
    assert v.shape == M.shape[:-1]
    assert se.launches == before and "small_eig.launch" not in counted


@pytest.mark.parametrize("n", list(range(se.MIN_N, se.MAX_N + 1)))
def test_small_eig_plain_version_finds_the_null_vector(n):
    """At every n the kernel is built for, the plain version's vector spans
    the null space of a rank n - 1 normal matrix."""
    M = _normal_matrices(np.random.default_rng(100 + n), (16,), n, n - 1)
    v = se._smallest_eigvec_torch(M)
    np.testing.assert_allclose(torch.linalg.vector_norm(v, dim=-1).numpy(), 1.0, atol=1e-6)
    assert float(torch.linalg.vector_norm(M @ v[..., None], dim=(-2, -1)).max()) <= 1e-5


def test_smallest_eigvec_float64_cpu_takes_the_plain_version():
    """A float64 CPU tensor (the tests' yardstick) runs the plain version
    in float64; the wrapper itself takes float32 only."""
    from visualodometry_tpu_torch.geometry import linalg

    M = _normal_matrices(np.random.default_rng(9), (4,), 9, 8).double()
    v = linalg.smallest_eigvec(M)
    assert v.dtype == torch.float64 and torch.equal(v, se._smallest_eigvec_torch(M))


def test_small_eig_checks_inputs():
    with pytest.raises(TypeError):
        se.smallest_eigvec(torch.eye(4, dtype=torch.float64))
    for bad in (torch.eye(3), torch.eye(17), torch.zeros(2, 4, 5), torch.zeros(4)):
        with pytest.raises(ValueError):
            se.smallest_eigvec(bad)


def test_smallest_eigvec_n3_takes_the_closed_form(monkeypatch):
    from visualodometry_tpu_torch.geometry import linalg

    def refuse(*args, **kwargs):
        raise AssertionError("n = 3 reached ops/small_eig.py")

    monkeypatch.setattr(se, "smallest_eigvec", refuse)
    M = _normal_matrices(np.random.default_rng(3), (7,), 3, 2)
    assert torch.equal(linalg.smallest_eigvec(M), linalg.eigh3(M)[1][..., :, 0])


def _small_eig_gap(M):
    """Kernel against the plain version on the same card: the largest
    absolute gap and how many vectors are bit-equal."""
    vk = se.smallest_eigvec(M)
    vp = se._smallest_eigvec_torch(M)
    torch.cuda.synchronize()
    assert vk.shape == vp.shape == M.shape[:-1]
    assert bool(torch.isfinite(vk).all())
    same = int((vk == vp).all(dim=-1).sum())
    return float((vk - vp).abs().max()), same


@pytest.mark.cuda
@pytest.mark.parametrize("batch, n, rank", [
    ((256,), 12, 11), ((512,), 12, 11),  # DLT PnP
    ((4096,), 4, 3),  # keyframe triangulation
    ((256,), 9, 8),  # the eight-point essential system
    ((2, 3), 12, 11),  # leading dims
])
def test_small_eig_kernel_matches_plain(cuda_device, batch, n, rank):
    """Within 1e-5 of the plain version: the two differ only in the order
    of the trace's and the squared norm's sums (csrc/small_eig.cu)."""
    M = _normal_matrices(np.random.default_rng(n * rank), batch, n, rank).to(cuda_device)
    gap, _ = _small_eig_gap(M)
    assert gap <= 1e-5, gap


@pytest.mark.cuda
@pytest.mark.parametrize("n", list(range(se.MIN_N, se.MAX_N + 1)))
def test_small_eig_kernel_every_n(cuda_device, n):
    """Every instantiation, on a ragged batch of 37 (one full block of 32
    and a part block)."""
    M = _normal_matrices(np.random.default_rng(200 + n), (37,), n, n - 1).to(cuda_device)
    gap, _ = _small_eig_gap(M)
    assert gap <= 1e-5, (n, gap)


@pytest.mark.cuda
def test_small_eig_zero_matrix_stays_finite(cuda_device):
    """All-zero matrices: the pivots clamp, the vector stays finite and is
    the normalised start vector, as in the plain version."""
    M = torch.zeros(40, 12, 12, device=cuda_device)
    gap, _ = _small_eig_gap(M)
    assert gap <= 1e-6
    start = 1.0 + 0.01 * torch.arange(12, dtype=torch.float32)
    want = start / torch.linalg.vector_norm(start)
    got = se.smallest_eigvec(M).cpu()
    np.testing.assert_allclose(got.numpy(), want.expand(40, 12).numpy(), atol=1e-6)


@pytest.mark.cuda
def test_small_eig_repeats_counts_and_adds_no_sync(cuda_device):
    """Two calls bit-equal; one launch counted a call; no host read."""
    M = _normal_matrices(np.random.default_rng(7), (256,), 12, 11).to(cuda_device)
    before = se.launches
    a = se.smallest_eigvec(M)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = se.smallest_eigvec(M)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(a, b)
    assert se.launches == before + 2
    with pytest.raises(ValueError, match="contiguous"):
        se.smallest_eigvec(M.transpose(-1, -2))
