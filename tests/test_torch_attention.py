"""The port's attention matcher vs the JAX package on the CPU.

Inputs: the port's SIFT features of two rendered 640x192 corridor frames at
256 slots, with every tenth query slot masked on top of the slots the
extractor left empty. Weights: the bundled Flax checkpoints carried across
by the port's converter: `attention_matcher_sift.pkl` (shared heads, full
depth) and `attention_matcher_sift_v2.pkl` (per-layer heads, `adaptive_match`
with pruning and early exit).

- float32: scores within 1e-4 of the largest, matchability within 1e-5,
  the same matches (the products sum in another order, nothing else
  differs).
- bf16: >= 95% of the JAX matches equal, the match count within 5% (the
  frameworks round at the same places, but a bf16 step in a logit near
  the 0.2 threshold or a tie can flip a slot).
- The attention path end to end through `make_chunked_pipeline_fn` on a
  640x192, 12-frame fixture (SIFT, 512 slots, the v2 weights with pruning
  to 256) against the JAX runner: resets, init frame, keyframe flags within
  one frame, sim3 ATE within 0.01 m of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.core import init_state as jinit
from visualodometry_tpu.core.runner import make_chunked_pipeline_fn as jpipeline
from visualodometry_tpu.eval import ate_rmse as jate
from visualodometry_tpu.models import attention_matcher as jam
from visualodometry_tpu_torch.config import VOConfig, config_from_dict
from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn, make_step_fn
from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
from visualodometry_tpu_torch.eval import ate_rmse
from visualodometry_tpu_torch.frontend.sift import extract_sift
from visualodometry_tpu_torch.models import attention_matcher as tam
from visualodometry_tpu_torch.models import convert, weights

torch.set_num_threads(2)

SIZE = (640, 192)
DTYPES = {"float32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def pair():
    """Port tensors and JAX arrays of (kps0, desc0, valid0, kps1, desc1, valid1)."""
    scene = make_scene(np.random.default_rng(7), num_frames=2, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=SIZE)
    u8 = render_fixture_u8(scene)
    cfg = VOConfig(extractor_type="sift", max_keypoints=256, sift_n_features=256,
                   sift_contrast_threshold=0.02, sift_num_octaves=3, image_size=SIZE)
    f0, f1 = (extract_sift(torch.as_tensor(u), cfg, device="cpu") for u in u8)
    valid0 = f0.valid.clone()
    valid0[::10] = False
    t = (tam.normalize_kps(f0.kps, SIZE), f0.desc, valid0,
         tam.normalize_kps(f1.kps, SIZE), f1.desc, f1.valid)
    assert 150 <= int(valid0.sum()) < 256 and 150 <= int(f1.valid.sum()) < 256
    return t, tuple(jnp.asarray(x.numpy()) for x in t)


def _models(name, dtype, per_layer_heads):
    params = weights.load_flax_pickle(weights.bundled(name))
    cd_j, cd_t = DTYPES[dtype]
    jm = jam.AttentionMatcher(depth=4, per_layer_heads=per_layer_heads, compute_dtype=cd_j)
    tm = tam.AttentionMatcher(desc_dim=128, depth=4, per_layer_heads=per_layer_heads,
                              compute_dtype=cd_t)
    tm.load_state_dict(convert.attention_state_dict_from_flax(params))
    return jm, jax.tree.map(jnp.asarray, params), tm.eval()


def _assert_matches(got, want, dtype):
    vj, ij = np.asarray(want.valid), np.asarray(want.idx)
    vt, it = got.valid.numpy(), got.idx.numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(it[vj], ij[vj])
    else:
        same = vj & vt & (ij == it)
        assert same.sum() >= 0.95 * vj.sum() and abs(int(vt.sum()) - int(vj.sum())) <= 0.05 * vj.sum()
    assert vj.sum() >= 50


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_full_depth_matches_jax(pair, dtype):
    """Shared heads, every block: scores, matchability and the assignment."""
    (t, j) = pair
    jm, params, tm = _models("attention_matcher_sift.pkl", dtype, False)
    sim_j, m0_j, m1_j = (np.asarray(x) for x in jm.apply(params, *j))
    with torch.no_grad():
        sim, m0, m1 = (x.numpy() for x in tm(*t))
    if dtype == "float32":
        assert np.abs(sim - sim_j).max() <= 1e-4 * np.abs(sim_j).max()
        np.testing.assert_allclose(m0, m0_j, atol=1e-5)
        np.testing.assert_allclose(m1, m1_j, atol=1e-5)
    want = jam.assignment_from_scores(jnp.asarray(sim_j), jnp.asarray(m0_j), jnp.asarray(m1_j),
                                      j[2], j[5])
    got = tam.assignment_from_scores(*(torch.as_tensor(x) for x in (sim, m0, m1)), t[2], t[5])
    _assert_matches(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("prune_to,exit_conf", [(0, 0.0), (128, 0.0), (128, 0.5)])
def test_adaptive_match_matches_jax(pair, dtype, prune_to, exit_conf):
    """The v2 weights: no pruning, pruning to 128 of 256 slots, and pruning
    with an exit threshold that this pair reaches after block 1 or 2 (the
    results then differ from the run without exit, so the exit is taken)."""
    (t, j) = pair
    jm, params, tm = _models("attention_matcher_sift_v2.pkl", dtype, True)
    want = jam.adaptive_match(jm, params, *j, prune_to=prune_to, exit_conf=exit_conf)
    with torch.no_grad():
        got = tam.adaptive_match(tm, *t, prune_to=prune_to, exit_conf=exit_conf)
        if exit_conf:
            full = tam.adaptive_match(tm, *t, prune_to=prune_to, exit_conf=0.0)
            assert not torch.equal(full.valid, got.valid)
    assert got.idx.dtype == torch.int32 and got.idx.shape == (256,)
    _assert_matches(got, want, dtype)
    if prune_to:
        assert int(got.valid.sum()) <= prune_to


def test_adaptive_match_needs_per_layer_heads(pair):
    tm = tam.AttentionMatcher(depth=2)
    with pytest.raises(ValueError, match="per-layer heads"):
        tam.adaptive_match(tm, *pair[0])


def test_assignment_from_scores_matches_jax():
    """Random scores with masked rows and columns, and a score matrix whose
    keys are all masked: a uniform softmax, no NaN, no match."""
    rng = np.random.default_rng(3)
    sim = (rng.normal(size=(64, 80)) * 10).astype(np.float32)
    m0, m1 = (rng.random(n).astype(np.float32) for n in (64, 80))
    v0, v1 = rng.random(64) > 0.2, rng.random(80) > 0.3
    for valid1 in (v1, np.zeros(80, bool)):
        want = jam.assignment_from_scores(*(jnp.asarray(x) for x in (sim, m0, m1, v0, valid1)))
        got = tam.assignment_from_scores(*(torch.as_tensor(x) for x in (sim, m0, m1, v0, valid1)))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert not got.valid.any() and want.valid.sum() == 0


def test_normalize_kps_matches_jax():
    kps = np.random.default_rng(4).random((10, 2)).astype(np.float32) * [1226, 370]
    want = np.asarray(jam.normalize_kps(jnp.asarray(kps), (1226, 370)))
    got = tam.normalize_kps(torch.as_tensor(kps), (1226, 370)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,per_layer", [
    ("attention_matcher_sift.pkl", False), ("attention_matcher_sift_v2.pkl", True),
    ("attention_matcher_sift_v3b.pkl", True), ("attention_matcher_synthetic.pkl", False),
])
def test_converter_fills_every_parameter(name, per_layer):
    params = weights.load_flax_pickle(weights.bundled(name))
    state = convert.attention_state_dict_from_flax(params)
    tm = tam.AttentionMatcher(desc_dim=128, depth=4, per_layer_heads=per_layer)
    tm.load_state_dict(state)  # strict: every key on both sides
    k = params["params"]["block2"]["self_attn"]["v"]["kernel"]
    np.testing.assert_array_equal(tm.blocks[2].self_attn.v.weight.detach().numpy(), k.T)
    last = params["params"]["out_proj"]["kernel"]
    np.testing.assert_array_equal(tm.out_projs[-1].weight.detach().numpy(), last.T)


def test_identity_residual_init_is_dual_softmax_nn():
    """Untrained, at a square input projection, the matcher's scores are the
    descriptors' dot products over the temperature, matchability sigmoid(2)."""
    tm = tam.AttentionMatcher(desc_dim=256, depth=2, compute_dtype=torch.bfloat16)
    tm.init_identity_residual(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    d0, d1 = (torch.as_tensor(rng.normal(size=(32, 256)).astype(np.float32)) for _ in range(2))
    k0, k1 = (torch.as_tensor(rng.random((32, 2)).astype(np.float32)) for _ in range(2))
    v = torch.ones(32, dtype=torch.bool)
    with torch.no_grad():
        sim, m0, m1 = tm(k0, d0, v, k1, d1, v)
    torch.testing.assert_close(sim, d0 @ d1.T / 0.05, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(m0, torch.full((32,), torch.sigmoid(torch.tensor(2.0)).item()))


def test_step_resolves_matcher_weights_as_jax():
    """Bundled weights at depth 4 on 128-D descriptors (v2 first, adaptive),
    `attention_weights` chooses another file, any other shape takes the
    identity-residual init."""
    K = np.eye(3, dtype=np.float32)
    base = VOConfig(extractor_type="sift", matcher_type="attention", attention_depth=4)
    step = make_step_fn(base, K, device="cpu")
    assert step.match.model.per_layer_heads
    v2 = weights.load_flax_pickle(weights.bundled("attention_matcher_sift_v2.pkl"))
    w = v2["params"]["block0"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(step.match.model.blocks[0].mlp0.weight.detach().numpy(), w.T)
    shared = make_step_fn(base.replace(attention_weights="attention_matcher_sift.pkl"), K,
                          device="cpu")
    assert not shared.match.model.per_layer_heads
    for cfg in (base.replace(attention_depth=2), base.replace(extractor_type="superpoint")):
        model = make_step_fn(cfg, K, device="cpu").match.model
        assert not model.per_layer_heads and model.depth == cfg.attention_depth
        assert float(model.match_heads[0].bias.detach()) == 2.0
    assert make_step_fn(base.replace(extractor_type="superpoint"), K,
                        device="cpu").match.model.in_proj.in_features == 256
    with pytest.raises(ValueError, match="matcher_type"):
        make_step_fn(base.replace(matcher_type="lightglue"), K, device="cpu")


# ---- the attention path end to end ---------------------------------------

CHUNK = 4
FRAMES = 12


def test_attention_path_tracks_like_jax():
    """bench.py's attention stage (`_build_cfg` with the attention matcher)
    cut for the CPU: 640x192, 512 slots with pruning to 256, 128 + 128
    hypotheses, 12 frames in chunks of 4."""
    scene = make_scene(np.random.default_rng(7), num_frames=FRAMES, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=SIZE)
    u8 = render_fixture_u8(scene)
    jc = JaxConfig(
        extractor_type="sift", max_keypoints=512, sift_n_features=512,
        sift_contrast_threshold=0.02, sift_num_octaves=3, min_median_flow=3.0,
        max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0, min_parallax_deg=0.35,
        lowe_ratio=0.8, essential_hypotheses=128, pnp_hypotheses=128, map_capacity=4096,
        matcher_type="attention", attention_prune_to=256, image_size=SIZE,
    )
    run_j = jpipeline(jc, scene.K)
    state_j = jinit(jc, desc_dim=128)
    tc = config_from_dict(dataclasses.asdict(jc))
    run = make_chunked_pipeline_fn(tc, scene.K, device="cpu")
    assert run.step.match.model.per_layer_heads
    state = init_state(tc, desc_dim=128, device="cpu")
    outs, outs_j = [], []
    for i in range(0, FRAMES, CHUNK):
        state_j, out_j = run_j(state_j, jnp.asarray(u8[i : i + CHUNK]))
        outs_j.append(jax.tree.map(np.asarray, out_j))
        state, out = run(state, u8[i : i + CHUNK])
        outs.append(out)
    out_j = jax.tree.map(lambda *xs: np.concatenate(xs), *outs_j)
    T, kf, resets, init = (torch.cat([getattr(o, k) for o in outs]).numpy()
                           for k in ("T_wc", "is_keyframe", "did_reset", "initialized"))
    gt = scene.gt_positions
    assert T.shape == (FRAMES, 4, 4) and np.isfinite(T).all()
    assert resets.sum() == out_j.did_reset.sum() == 0
    assert np.argmax(init) == np.argmax(out_j.initialized)
    assert (kf != out_j.is_keyframe).sum() <= 1
    nm = torch.cat([o.num_matches for o in outs]).numpy()
    assert (nm[1:] >= 0.8 * out_j.num_matches[1:]).all(), (nm, out_j.num_matches)
    ate_t = ate_rmse(T[8:, :3, 3], gt[8:], align="sim3")
    ate_j = jate(out_j.T_wc[8:, :3, 3], gt[8:], align="sim3")
    assert ate_j < 0.05 and abs(ate_t - ate_j) <= 0.01, (ate_t, ate_j)
