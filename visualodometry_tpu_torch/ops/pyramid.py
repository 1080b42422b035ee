"""Gaussian scale-space and Difference-of-Gaussians pyramids.

Port of the band-matmul path of visualodometry_tpu/ops/pyramid.py: a 1D
edge-padded convolution along an axis of length n is a matmul with an
(n, n) band matrix, so one octave's Gaussian stack is two batched matrix
products. These are large plain products (XLA ran them outside any Pallas
kernel), so here they are `torch.matmul` in full float32 (TF32 is off,
see the package docstring): the DoG contrast threshold is O(2.5e-3).

Every function takes a leading batch of frames: (..., H, W) in,
(..., C, H, W) out. The band matrices are built with numpy per static
shape and cached, and so are their device copies, per device (the
octave-0 matrices are ~30 MB; uploading them per frame would dominate).

The second route is the blur stack, the counterpart of the Pallas kernel
`blur_stack_pallas`: `blur_stack` runs the hand-written CUDA kernel
(csrc/blur_stack.cu) for CUDA tensors and the plain PyTorch version
`_blur_stack_torch` for CPU tensors. It is opt-in (`impl="pallas"`, the
JAX argument's value, kept so a reader finds the counterpart); `"auto"`
means the band matmul, as in the JAX package. What the TPU kernel needed
and this one does not is dropped: the halo rounded up to a multiple of 4
and the fixed 32-row tile of Mosaic's DMA alignment, the 64/128-lane
padding, and `_pallas_blur_fits` with its fall-back to band matmuls when
the upsampled base octave overflowed scoped VMEM. The CUDA kernel takes
every image shape, radii up to 64 (the limit the JAX kernel asserts, held
on every device) and up to 8 channels (the pyramid makes 3-8), so
`impl="pallas"` never runs a band matmul here. Its taps travel by value:
`_pack_taps` lays them out as the launch receives them.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from visualodometry_tpu_torch.ops import _build

# blur-stack kernel launches since the last reset (callers zero it)
launches = 0


def _full_kernel_np(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _band_matrix_np(n: int, kern: np.ndarray) -> np.ndarray:
    """(n, n) matrix B with (row_in @ B) == edge-padded 1D conv of row_in."""
    r = (len(kern) - 1) // 2
    B = np.zeros((n, n), np.float32)
    for i in range(n):
        for t in range(-r, r + 1):
            j = min(max(i + t, 0), n - 1)
            B[j, i] += kern[t + r]
    return B


@lru_cache(maxsize=None)
def _blur_mats(h: int, w: int, sigma: float):
    k = _full_kernel_np(sigma, max(1, int(math.ceil(3.0 * sigma))))
    return _band_matrix_np(h, k), _band_matrix_np(w, k)


@lru_cache(maxsize=None)
def _octave_mats(h: int, w: int, scales: int, sigma0: float):
    """Per-level band matrices for one octave: (C, H, H) and (C, W, W).

    Level i of the stack has absolute blur sigma0 * 2^((i+1)/scales),
    produced directly from the octave base in one hop.
    """
    k = 2.0 ** (1.0 / scales)
    n_out = scales + 2
    sigmas = [
        math.sqrt(max((sigma0 * k ** (i + 1)) ** 2 - sigma0**2, 1e-8))
        for i in range(n_out)
    ]
    radius = max(1, int(math.ceil(3.0 * max(sigmas))))
    Bv = np.stack([_band_matrix_np(h, _full_kernel_np(s, radius)) for s in sigmas])
    Bh = np.stack([_band_matrix_np(w, _full_kernel_np(s, radius)) for s in sigmas])
    return Bv, Bh


@lru_cache(maxsize=None)
def _blur_mats_on(h: int, w: int, sigma: float, device: torch.device):
    return tuple(torch.as_tensor(m).to(device) for m in _blur_mats(h, w, sigma))


@lru_cache(maxsize=None)
def _octave_mats_on(h: int, w: int, scales: int, sigma0: float, device: torch.device):
    return tuple(
        torch.as_tensor(m).to(device) for m in _octave_mats(h, w, scales, sigma0)
    )


def blur_2d(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) with edge ("SAME") handling."""
    H, W = img.shape[-2:]
    sigma = float(sigma)
    Bv, Bh = _blur_mats_on(H, W, sigma, img.device)
    # out = Bv^T @ img @ Bh  (B maps input index -> output index)
    return Bv.T @ (img.to(torch.float32) @ Bh)


def build_gaussian_octave(
    base: torch.Tensor, sigma0: float, scales: int
) -> torch.Tensor:
    """(..., scales+3, H, W) Gaussian stack for one octave (level 0 = base)."""
    H, W = base.shape[-2:]
    Bv, Bh = _octave_mats_on(H, W, scales, float(sigma0), base.device)
    # one (frames*H, W) @ (W, W) product per level, then the vertical pass
    levels = [Bv[c].T @ (base @ Bh[c]) for c in range(Bh.shape[0])]
    return torch.stack([base, *levels], dim=-3)


def downsample_2x(img: torch.Tensor) -> torch.Tensor:
    return img[..., ::2, ::2].contiguous()


@lru_cache(maxsize=None)
def _stack_taps(scales: int, sigma0: float) -> tuple[tuple[float, ...], ...]:
    """Per-channel 1D taps for one octave, all at the shared stack-max
    radius of the band-matmul path (`_octave_mats`).

    Channel i has incremental blur sqrt((sigma0*k^(i+1))^2 - sigma0^2)
    applied to the octave base. (A per-channel radius changes the blur by
    ~5e-4, enough to flip marginal DoG extrema; the JAX package measured
    and reverted it.)
    """
    k = 2.0 ** (1.0 / scales)
    sigmas = [
        math.sqrt(max((sigma0 * k ** (i + 1)) ** 2 - sigma0**2, 1e-8))
        for i in range(scales + 2)
    ]
    radius = max(1, int(math.ceil(3.0 * max(sigmas))))
    return tuple(
        tuple(_full_kernel_np(s, radius).tolist()) for s in sigmas
    )


# the largest radius the kernel takes, as the JAX kernel asserts
MAX_RADIUS = 64
# the most channels the kernel takes (the pyramid gives 3-8)
MAX_CHANNELS = 8
# padded tap counts the kernel is built for: the pyramid's 12, 16 and 32,
# and enough others to take every radius up to MAX_RADIUS
TAP_COUNTS = (8, 12, 16, 24, 32, 40, 48, 64, 80, 96, 112, 132)


def _check_taps(taps: tuple[tuple[float, ...], ...]) -> tuple[int, int]:
    """(C, T) of a tap set, or ValueError: C rows of one odd length with
    radius (T - 1) / 2 <= MAX_RADIUS."""
    lengths = {len(row) for row in taps}
    if not taps or len(lengths) != 1 or lengths.pop() % 2 != 1:
        raise ValueError("blur_stack: taps must be C rows of one odd length")
    C, T = len(taps), len(taps[0])
    if (T - 1) // 2 > MAX_RADIUS:
        raise ValueError(f"blur_stack: radius {(T - 1) // 2} > {MAX_RADIUS}")
    return C, T


@lru_cache(maxsize=None)
def _taps_on(taps: tuple[tuple[float, ...], ...], device: torch.device) -> torch.Tensor:
    """The (C, T) taps as a float32 tensor, for the plain version."""
    _check_taps(taps)
    return torch.tensor(taps, dtype=torch.float32).to(device)


@lru_cache(maxsize=None)
def _pack_taps(taps: tuple[tuple[float, ...], ...]) -> tuple[np.ndarray, int]:
    """The taps as the kernel receives them, by value: (C, TP) float32, each
    row after (-R) mod 4 leading zeros and zero-padded to TP, the smallest
    of TAP_COUNTS that holds it; and RA, R plus the leading zeros.

    A zero tap adds exactly nothing to a finite sum that starts at 0.0, so
    the kernel's tap-order chains give the unpadded result bit for bit;
    the leading zeros make the tile's left edge x0 - RA a multiple of 4.
    """
    C, T = _check_taps(taps)
    R = (T - 1) // 2
    lead = -R % 4
    TP = next(n for n in TAP_COUNTS if n >= lead + T)
    packed = np.zeros((C, TP), np.float32)
    packed[:, lead : lead + T] = np.asarray(taps, np.float32)
    return packed, R + lead


def _blur_stack_torch(bases: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Plain version: edge-pad, then two sums over shifted slices.

    bases (B, H, W), taps (C, T) -> (B, C, H, W), float32, every sum in
    tap order (tap 0 first) like the kernel.
    """
    B, H, W = bases.shape
    C, T = taps.shape
    R = (T - 1) // 2
    padded = F.pad(bases[:, None], (R, R, R, R), mode="replicate")  # (B,1,H+2R,W+2R)
    w = taps.reshape(1, C, 1, 1, T)
    h = w[..., 0] * padded[..., 0:W]
    for t in range(1, T):
        h = h + w[..., t] * padded[..., t : t + W]
    out = w[..., 0] * h[:, :, 0:H]
    for t in range(1, T):
        out = out + w[..., t] * h[:, :, t : t + H]
    return out


def blur_stack(bases: torch.Tensor, taps: tuple[tuple[float, ...], ...]) -> torch.Tensor:
    """(..., H, W) bases -> (..., C, H, W) Gaussian stacks, C = len(taps).

    Channel c is the edge-padded separable convolution of the base with
    the static tap vector `taps[c]`; all vectors have one odd length.
    CUDA tensors launch the kernel (one launch for the whole batch, one
    read of each base for all channels); CPU tensors take the plain
    version. There is no fallback between the two.
    """
    global launches
    if bases.dtype != torch.float32 or bases.dim() < 2:
        raise TypeError("blur_stack: bases must be (..., H, W) float32")
    lead = bases.shape[:-2]
    H, W = bases.shape[-2:]
    C, T = _check_taps(taps)
    flat = bases.reshape(-1, H, W)
    if bases.device.type == "cpu":
        return _blur_stack_torch(flat, _taps_on(taps, bases.device)).reshape(*lead, C, H, W)
    if bases.device.type != "cuda":
        raise ValueError(f"blur_stack: unsupported device {bases.device}")
    if C > MAX_CHANNELS:
        raise ValueError(f"blur_stack: {C} channels > {MAX_CHANNELS}")
    packed, RA = _pack_taps(taps)
    flat = flat.contiguous()
    out = torch.empty((flat.shape[0], C, H, W), dtype=torch.float32, device=bases.device)
    fn = _library().blur_stack_launch
    err = fn(
        flat.data_ptr(), packed.ctypes.data, out.data_ptr(), flat.shape[0], C,
        packed.shape[1], RA, H, W, _build.current_stream_handle(bases.device),
    )
    _build.check_launch("blur_stack", err)
    launches += 1
    return out.reshape(*lead, C, H, W)


def _library() -> ctypes.CDLL:
    lib = _build.load_library("blur_stack")
    lib.blur_stack_launch.restype = ctypes.c_int
    lib.blur_stack_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    )
    lib.blur_stack_variant.restype = ctypes.c_int
    lib.blur_stack_variant.argtypes = [ctypes.c_int] * 2
    return lib


def blur_stack_instantiation(taps: tuple[tuple[float, ...], ...]) -> str:
    """Which build of the kernel a launch with these taps runs: "specialised"
    (compiled for its (C, TP)) or "generic" (C at run time). Asks the built
    library, so it needs nvcc."""
    packed, _ = _pack_taps(taps)
    v = _library().blur_stack_variant(*packed.shape)
    return {1: "specialised", 0: "generic"}.get(v, "none")


def build_gaussian_octave_pallas(
    base: torch.Tensor, sigma0: float, scales: int
) -> torch.Tensor:
    """Drop-in for `build_gaussian_octave` through the blur stack."""
    x = blur_stack(base, _stack_taps(scales, float(sigma0)))
    return torch.cat([base[..., None, :, :], x], dim=-3)


def upsample_2x(img: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample of (..., H, W), half-pixel centres, edges
    clamped: what `jax.image.resize(img, (2H, 2W), "linear")` computes."""
    H, W = img.shape[-2:]
    out = F.interpolate(
        img.reshape(-1, 1, H, W), size=(2 * H, 2 * W), mode="bilinear",
        align_corners=False,
    )
    return out.reshape(*img.shape[:-2], 2 * H, 2 * W)


def build_pyramid(
    img: torch.Tensor,
    num_octaves: int,
    scales: int,
    sigma0: float = 1.6,
    assumed_blur: float = 0.5,
    first_octave: int = 0,
    impl: str = "auto",
):
    """Full Gaussian + DoG pyramids of (..., H, W) float32 images.

    Returns (gauss, dogs): lists over octaves of (..., scales+3, Ho, Wo)
    and (..., scales+2, Ho, Wo). Like OpenCV SIFT, the input is
    pre-blurred up to sigma0 assuming `assumed_blur` sensor blur.

    `first_octave=-1` adds cv2.SIFT's upsampled base octave (bilinear 2x;
    the assumed sensor blur doubles); mapping coordinates back to input
    pixels is the caller's job via 2^(o + first_octave). `impl`: "auto" and
    "matmul" run the band matmuls; "pallas" runs the blur stack for the
    base pre-blur and for every octave.
    """
    if first_octave not in (0, -1):
        raise ValueError(f"build_pyramid: first_octave must be 0 or -1, not {first_octave}")
    if impl not in ("auto", "matmul", "pallas"):
        raise ValueError(f"build_pyramid: unknown impl {impl!r}")
    img = img.to(torch.float32)
    if first_octave == -1:
        img = upsample_2x(img)
        assumed_blur = 2.0 * assumed_blur
    sig_diff = math.sqrt(max(sigma0**2 - assumed_blur**2, 1e-8))
    if impl == "pallas":
        base_taps = (
            tuple(
                _full_kernel_np(sig_diff, max(1, int(math.ceil(3.0 * sig_diff)))).tolist()
            ),
        )
        base = blur_stack(img, base_taps)[..., 0, :, :]
        octave = build_gaussian_octave_pallas
    else:
        base = blur_2d(img, sig_diff)
        octave = build_gaussian_octave
    gauss, dogs = [], []
    for _ in range(num_octaves):
        stack = octave(base, sigma0, scales)
        gauss.append(stack)
        dogs.append(stack[..., 1:, :, :] - stack[..., :-1, :, :])
        # next octave seeds from the level with 2*sigma0 blur
        base = downsample_2x(stack[..., scales, :, :])
    return gauss, dogs
