"""Attention-based sparse feature matcher (LightGlue architecture class).

Port of visualodometry_tpu/models/attention_matcher.py: L blocks of masked
self- and cross-attention over the two keypoint sets with an MLP
positional encoding, then a dual-softmax assignment gated by per-point
matchability. `adaptive_match` adds the v2 checkpoints' width pruning
after block 0 and the early exit on per-layer confidence.

Precision, as the JAX package's `compute_dtype`: with bf16, every Dense
layer of the attention and the MLP casts its input, weight and bias to
bf16 and rounds its product and then its sum with the bias to bf16. The two
attention products take bf16 operands and accumulate in float32; they are
formed here from the operands upcast to float32, which is exact for
products of bf16 values. Softmax is float32 and its result is rounded to
bf16. The residual stream, `in_proj`, the positional encoder and the heads
stay float32.

Attention is plain `matmul` + `softmax` with masked logits set to -1e9,
as in the JAX package: a row whose keys are all masked gets a uniform
distribution (a -inf mask would give NaN there).

Early exit without a host read: `adaptive_match` runs every block and keeps
the previous block's results wherever the exit flag, a device tensor that
stays set once set, says the JAX program would have skipped it. The
results equal the skipping program's; the skipped blocks' work is done and
thrown away.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from visualodometry_tpu_torch.frontend.matcher import MatchResult

_NEG = -1e9


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax `Dense(dtype=dtype)`: input, kernel and bias in `dtype`, the
    product and then the bias added, each rounded to `dtype`."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax.linen.gelu's default


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.q, self.k, self.v, self.proj = (nn.Linear(dim, dim) for _ in range(4))

    def forward(self, q_in, kv_in, kv_mask):
        h, dt = self.heads, self.dtype
        n_q, dim = q_in.shape
        dh = dim // h
        q = _dense(self.q, q_in, dt).reshape(n_q, h, dh).transpose(0, 1).float()
        k = _dense(self.k, kv_in, dt).reshape(-1, h, dh).transpose(0, 1).float()
        v = _dense(self.v, kv_in, dt).reshape(-1, h, dh).transpose(0, 1).float()
        logits = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(dh)  # (h, q, k)
        logits = torch.where(kv_mask[None, None, :], logits, _NEG)
        attn = torch.softmax(logits, dim=-1).to(dt)
        out = torch.matmul(attn.float(), v).transpose(0, 1).reshape(n_q, dim)
        return _dense(self.proj, out, dt)


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.self_attn = _Attention(dim, heads, dtype)
        self.cross_attn = _Attention(dim, heads, dtype)
        self.mlp0 = nn.Linear(dim, 2 * dim)
        self.mlp1 = nn.Linear(2 * dim, dim)

    def _mlp(self, x):
        return _dense(self.mlp1, _gelu(_dense(self.mlp0, x, self.dtype)), self.dtype)

    def forward(self, x0, x1, m0, m1):
        x0 = x0 + self.self_attn(x0, x0, m0)
        x1 = x1 + self.self_attn(x1, x1, m1)
        x0n, x1n = x0, x1
        x0 = x0 + self.cross_attn(x0n, x1n, m1)
        x1 = x1 + self.cross_attn(x1n, x0n, m0)
        return x0 + self._mlp(x0), x1 + self._mlp(x1)


class AttentionMatcher(nn.Module):
    """The matcher's layers; `forward` is the full-depth pass.

    desc_dim is the descriptor depth the input projection takes (128 for
    SIFT, 256 for SuperPoint). With `per_layer_heads` (the v2 checkpoints)
    every block has its own similarity projection, matchability and
    confidence head; otherwise one shared projection and matchability head.
    """

    def __init__(
        self,
        desc_dim: int = 128,
        dim: int = 256,
        heads: int = 4,
        depth: int = 6,
        temperature: float = 0.05,
        per_layer_heads: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dim, self.depth, self.temperature = dim, depth, temperature
        self.per_layer_heads = per_layer_heads
        self.in_proj = nn.Linear(desc_dim, dim)
        self.pos_d0 = nn.Linear(2, 64)
        self.pos_d1 = nn.Linear(64, dim)
        self.blocks = nn.ModuleList(_Block(dim, heads, compute_dtype) for _ in range(depth))
        n_heads = depth if per_layer_heads else 1
        self.out_projs = nn.ModuleList(nn.Linear(dim, dim, bias=False) for _ in range(n_heads))
        self.match_heads = nn.ModuleList(nn.Linear(dim, 1) for _ in range(n_heads))
        self.conf_heads = nn.ModuleList(
            nn.Linear(dim, 1) for _ in range(depth if per_layer_heads else 0)
        )

    @torch.no_grad()
    def init_identity_residual(self, generator: torch.Generator) -> None:
        """The JAX module's initializers: every attention and MLP output
        projection zero, the similarity projection the identity,
        matchability bias 2, `in_proj` the identity when it is square; the
        other kernels LeCun-normal from `generator`, biases zero. Untrained,
        the matcher is then temperature-scaled dual-softmax mutual-nearest
        matching on `in_proj` of the descriptors."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                w = m.weight
                w.copy_(torch.randn(w.shape, generator=generator) / w.shape[1] ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
        if self.in_proj.weight.shape[0] == self.in_proj.weight.shape[1]:
            self.in_proj.weight.copy_(torch.eye(self.dim))
        self.pos_d1.weight.zero_()
        for b in self.blocks:
            for layer in (b.self_attn.proj, b.cross_attn.proj, b.mlp1):
                layer.weight.zero_()
        for layer in self.out_projs:
            layer.weight.copy_(torch.eye(self.dim))
        for layer in self.match_heads:
            layer.weight.zero_()
            layer.bias.fill_(2.0)
        for layer in self.conf_heads:
            layer.weight.zero_()

    def pos_enc(self, kps):
        return self.pos_d1(_gelu(self.pos_d0(kps)))

    def embed(self, kps0, desc0, kps1, desc1):
        return (self.in_proj(desc0) + self.pos_enc(kps0),
                self.in_proj(desc1) + self.pos_enc(kps1))

    def run_block(self, i: int, x0, x1, m0, m1):
        return self.blocks[i](x0, x1, m0, m1)

    def _head(self, i: int) -> int:
        return i if self.per_layer_heads else 0

    def matchability_at(self, i: int, x0, x1):
        head = self.match_heads[self._head(i)]
        return torch.sigmoid(head(x0))[:, 0], torch.sigmoid(head(x1))[:, 0]

    def heads_at(self, i: int, x0, x1):
        """(sim, m0, m1) from layer-i embeddings (the shared head when the
        heads are not per layer)."""
        proj = self.out_projs[self._head(i)]
        sim = torch.matmul(proj(x0), proj(x1).T) / self.temperature
        return (sim, *self.matchability_at(i, x0, x1))

    def confidence_at(self, i: int, x0, x1):
        head = self.conf_heads[i]
        return torch.sigmoid(head(x0))[:, 0], torch.sigmoid(head(x1))[:, 0]

    def forward(self, kps0, desc0, valid0, kps1, desc1, valid1):
        """Full depth. Normalized kps (N, 2) in [-1, 1].

        Returns (scores (N0, N1), matchability0 (N0,), matchability1)."""
        x0, x1 = self.embed(kps0, desc0, kps1, desc1)
        for i in range(self.depth):
            x0, x1 = self.run_block(i, x0, x1, valid0, valid1)
        return self.heads_at(self.depth - 1, x0, x1)


def assignment_from_scores(sim, m0, m1, valid0, valid1, threshold: float = 0.2) -> MatchResult:
    """Dual-softmax + mutual-argmax assignment (fixed shape).

    score_ij = softmax_row(sim)_ij * softmax_col(sim)_ij * m0_i * m1_j; a
    pair matches iff it is the mutual argmax and scores above threshold.
    """
    sim = torch.where(valid1[None, :], sim, _NEG)
    sim = torch.where(valid0[:, None], sim, _NEG)
    scores = torch.softmax(sim, dim=1) * torch.softmax(sim, dim=0) * m0[:, None] * m1[None, :]
    best_j = torch.argmax(scores, dim=1)
    best_i = torch.argmax(scores, dim=0)
    mutual = best_i[best_j] == torch.arange(sim.shape[0], device=sim.device)
    top = torch.gather(scores, 1, best_j[:, None])[:, 0]
    return MatchResult(idx=best_j.to(torch.int32), valid=valid0 & mutual & (top > threshold))


def _top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest, ties to the lower index (`lax.top_k`)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def adaptive_match(
    model: AttentionMatcher,
    kps0, desc0, valid0, kps1, desc1, valid1,
    prune_to: int = 0,
    exit_conf: float = 0.0,
    threshold: float = 0.2,
) -> MatchResult:
    """LightGlue-style adaptive inference: width pruning + depth exit.

    Needs a model with per-layer heads. Runs block 0 at full N, keeps the
    top-`prune_to` slots of each side by keep-score `1 - c (1 - m)`
    (invalid slots -1), runs the remaining blocks at that width, and after
    each but the last sets the exit flag when the share of valid points
    with confidence above 0.95 exceeds `exit_conf`; from then on every
    block's results are discarded (see the module docstring). Pruned slots
    return unmatched. prune_to=0 disables pruning; exit_conf=0 the exit.
    """
    if not model.per_layer_heads:
        raise ValueError("adaptive_match needs a model with per-layer heads")
    n = desc0.shape[0]
    x0, x1 = model.embed(kps0, desc0, kps1, desc1)
    x0, x1 = model.run_block(0, x0, x1, valid0, valid1)

    idx0 = idx1 = None
    v0, v1 = valid0, valid1
    if prune_to and prune_to < n:
        c0, c1 = model.confidence_at(0, x0, x1)
        m0, m1 = model.matchability_at(0, x0, x1)
        idx0 = _top_indices(torch.where(valid0, 1.0 - c0 * (1.0 - m0), -1.0), prune_to)
        idx1 = _top_indices(torch.where(valid1, 1.0 - c1 * (1.0 - m1), -1.0), prune_to)
        x0, x1 = x0[idx0], x1[idx1]
        v0, v1 = valid0[idx0], valid1[idx1]

    sim, m0, m1 = model.heads_at(0, x0, x1)
    done = torch.zeros((), dtype=torch.bool, device=x0.device)
    vcat = torch.cat([v0, v1])
    n_valid = torch.clamp(torch.sum(vcat.to(torch.float32)), min=1.0)
    for i in range(1, model.depth):
        nx0, nx1 = model.run_block(i, x0, x1, v0, v1)
        nsim, nm0, nm1 = model.heads_at(i, nx0, nx1)
        x0, x1, sim, m0, m1 = (
            torch.where(done, old, new)
            for old, new in ((x0, nx0), (x1, nx1), (sim, nsim), (m0, nm0), (m1, nm1))
        )
        if exit_conf > 0.0 and i < model.depth - 1:
            conf = torch.cat(model.confidence_at(i, nx0, nx1))
            frac = torch.sum(torch.where(vcat, (conf > 0.95).to(torch.float32), 0.0)) / n_valid
            done = done | (frac > exit_conf)

    res = assignment_from_scores(sim, m0, m1, v0, v1, threshold)
    if idx0 is None:
        return res
    # the P-slot assignment back into the N slots
    out_idx = torch.zeros(n, dtype=torch.int32, device=x0.device)
    out_valid = torch.zeros(n, dtype=torch.bool, device=x0.device)
    out_idx[idx0] = idx1[res.idx.long()].to(torch.int32)
    out_valid[idx0] = res.valid
    return MatchResult(idx=out_idx, valid=out_valid)


def normalize_kps(kps: torch.Tensor, image_size) -> torch.Tensor:
    """Pixel coords -> [-1, 1]^2 given (W, H)."""
    w, h = image_size
    return torch.stack([kps[:, 0] / float(w), kps[:, 1] / float(h)], dim=-1) * 2.0 - 1.0
