"""Top-2 L2 descriptor matching: CUDA kernel K1 and its plain version.

Counterpart of visualodometry_tpu/ops/match_pallas.py. `match_top2` runs
the hand-written kernel (csrc/match_top2.cu) for CUDA tensors and the
plain PyTorch version `_top2_torch` for CPU tensors; there is no fallback
from one to the other.

Products are float32-grade in both: the TPU kernel's bf16 products (with
f32 accumulation) are not carried over. The kernel forms them on the tensor
cores from a two-part TF32 split of each float32 value ("3xTF32"), so it
agrees with the float32 reference matcher `_top2_jnp` rather than with a
bf16 variant.

The kernel's grid is query tiles x train splits x lanes; each block writes
a partial (best, second, argbest) to a scratch tensor allocated here, and a
merge kernel of the same source combines the splits in order.

Lanes: (B, N0, D) queries against (B, N1, D) train rows with a (B, N1) mask
are B independent problems, matched in one launch (the VO step of B
sequences, parallel/multiseq.py). This is what `pallas_call`'s batching rule
gives the TPU kernel under `jax.vmap`: one more grid axis. Every lane is
computed exactly as its own 2-D call would be.
"""

from __future__ import annotations

import torch

from visualodometry_tpu_torch.ops import _build

_BIG = 1e30

# calls that reached the kernel since the last reset (a plain count; callers
# zero it). One call launches the split kernel and its merge kernel.
launches = 0

_TILE = 128  # query rows per block and train rows per tile in the kernel
MAX_SPLITS = 32


MAX_LANES = 65535  # the grid's third axis


def _splits(n0: int, n1: int, sms: int, lanes: int = 1) -> int:
    """Train-set splits so that query tiles x splits x lanes fills `sms` SMs
    once.

    At least 1, at most `MAX_SPLITS` and at most the number of train tiles
    (a split is never empty). Lanes share the SMs: at four lanes of 4096
    queries the 128 query tiles already fill an H100's 132 SMs, so 1.
    """
    if n0 < 0 or n1 < 0 or sms < 1 or lanes < 1:
        raise ValueError(
            f"match_top2: bad sizes n0={n0}, n1={n1}, sms={sms}, lanes={lanes}"
        )
    q_tiles = max(1, -(-n0 // _TILE)) * lanes
    t_tiles = max(1, -(-n1 // _TILE))
    return max(1, min(sms // q_tiles, MAX_SPLITS, t_tiles))


def _top2_torch(desc0, desc1, valid1):
    """Plain version: full distance matrix + masked reductions.

    Line-for-line port of `_top2_jnp` (visualodometry_tpu/frontend/
    matcher.py). Returns (best_d2, second_d2, best_idx int32). With a
    leading lane axis each lane goes through the 2-D version in turn, so a
    lane's result is bit-equal to its own 2-D call on the CPU.
    """
    if desc0.dim() == 3:
        lanes = [_top2_torch(a, b, v) for a, b, v in zip(desc0, desc1, valid1)]
        return tuple(torch.stack(x) for x in zip(*lanes))
    sq0 = torch.sum(desc0 * desc0, dim=1)
    sq1 = torch.sum(desc1 * desc1, dim=1)
    cross = desc0 @ desc1.T
    d2 = sq0[:, None] + sq1[None, :] - 2.0 * cross
    d2 = torch.clamp(d2, min=0.0)
    d2 = torch.where(valid1[None, :], d2, _BIG)

    best_idx = torch.argmin(d2, dim=1)  # first minimum on ties
    best_d2 = torch.gather(d2, 1, best_idx[:, None])[:, 0]
    rows = torch.arange(d2.shape[0], device=d2.device)
    d2_wo_best = d2.clone()
    d2_wo_best[rows, best_idx] = _BIG
    second_d2 = torch.min(d2_wo_best, dim=1).values
    return best_d2, second_d2, best_idx.to(torch.int32)


def _check(desc0, desc1, valid1):
    if desc0.dtype != torch.float32 or desc1.dtype != torch.float32:
        raise TypeError("match_top2: descriptors must be float32")
    if (
        desc0.dim() not in (2, 3) or desc1.dim() != desc0.dim()
        or desc0.shape[-1] != desc1.shape[-1] or desc0.shape[:-2] != desc1.shape[:-2]
    ):
        raise ValueError(
            f"match_top2: shapes {tuple(desc0.shape)} / {tuple(desc1.shape)}"
        )
    if valid1.dtype != torch.bool or valid1.shape != desc1.shape[:-1]:
        raise ValueError("match_top2: valid1 must be bool (N1,), or (B, N1) with lanes")
    if desc0.dim() == 3 and desc0.shape[0] > MAX_LANES:
        raise ValueError(f"match_top2: at most {MAX_LANES} lanes")
    if not (desc0.device == desc1.device == valid1.device):
        raise ValueError("match_top2: inputs on different devices")
    if desc0.shape[-1] < 1:
        raise ValueError("match_top2: descriptors need a depth of at least 1")


def match_top2(desc0: torch.Tensor, desc1: torch.Tensor, valid1: torch.Tensor):
    """Fused top-2 L2 matching. Returns (best_d2, second_d2, best_idx).

    desc0: (N0, D) float32 queries, desc1: (N1, D) float32 train rows,
    valid1: (N1,) bool; or the same with a leading lane axis B on all three,
    B problems in one launch, and outputs (B, N0). Invalid train rows never
    win (distance 1e30); ties go to the lowest index. CPU tensors take the
    plain version; CUDA tensors launch kernel K1 (one launch, whatever B).
    """
    global launches
    _check(desc0, desc1, valid1)
    if desc0.device.type == "cpu":
        return _top2_torch(desc0, desc1, valid1)
    if desc0.device.type != "cuda":
        raise ValueError(f"match_top2: unsupported device {desc0.device}")
    if not (desc0.is_contiguous() and desc1.is_contiguous()):
        raise ValueError("match_top2: descriptors must be contiguous")
    lanes = desc0.shape[0] if desc0.dim() == 3 else 1
    n0, d = desc0.shape[-2:]
    n1 = desc1.shape[-2]
    valid_u8 = valid1.contiguous().view(torch.uint8)  # held until the launch
    out_shape = desc0.shape[:-1]
    best = torch.empty(out_shape, dtype=torch.float32, device=desc0.device)
    second = torch.empty(out_shape, dtype=torch.float32, device=desc0.device)
    idx = torch.empty(out_shape, dtype=torch.int32, device=desc0.device)
    sms = torch.cuda.get_device_properties(desc0.device).multi_processor_count
    splits = _splits(n0, n1, sms, lanes)
    # the blocks' partial best, second (float32) and argbest (int32) words
    scratch = torch.empty(3 * lanes * splits * n0, dtype=torch.int32, device=desc0.device)
    err = _build.c_function("match_top2", "match_top2_launch")(
        desc0.data_ptr(), desc1.data_ptr(), valid_u8.data_ptr(),
        best.data_ptr(), second.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
        n0, n1, d, splits, lanes, _build.current_stream_handle(desc0.device),
    )
    _build.check_launch("match_top2", err)
    launches += 1
    return best, second, idx
