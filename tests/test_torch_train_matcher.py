"""The port's attention-matcher trainer and its data against the JAX package.

- Generators: `synthetic_match_batch`, `sample_batch` and `subsample_slots`
  give bit-equal arrays from the same `np.random.Generator` seed.
- The matcher: a JAX-initialised depth-2, dim-64, per-layer-heads matcher
  whose every parameter is then moved by 0.05 x N(0, 1) (numpy-seeded: at
  the identity-residual init the attention output projections are zero and
  most gradients would be too), carried across by the converter, on
  2 x 32 slots. `all_layers` within 1e-5 of the largest value of each
  output of the JAX method vmapped over the pairs, and the batched call
  within 1e-6 of the 2-D call pair by pair (another blocking of the same
  float32 products).
- `matcher_loss` and `matcher_loss_deep`: the loss within 1e-5 relative of
  `jax.value_and_grad`'s (float32 on both sides), each parameter's gradient
  within 1e-4 of its largest JAX gradient entry, or of 1e-4 of the largest
  entry over all parameters where that is larger (the key biases, whose
  gradient is zero in exact arithmetic and rounding noise on both sides).
- `evaluate`: the same precision and recall as JAX's on the same batch.
- Flax -> torch -> Flax is the identity on the bundled matcher files, and
  `save_params` -> JAX `load_params` gives the same scores (1e-5).
- `build_sift_match_dataset` on 2 pairs at 120x160 and 128 slots: the
  rendered pairs are bit-equal (both functions draw the same numbers); the
  one-to-one ground-truth helper fed the JAX package's SIFT features gives
  JAX's `gt_idx` exactly; the port's own features (its SIFT on the CPU)
  put a keypoint within 0.01 px of >= 95% of JAX's valid keypoints, and
  >= 85% of JAX's ground-truth pairs appear among the port's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.frontend.sift import extract_sift as jextract_sift
from visualodometry_tpu.models import attention_matcher as jam
from visualodometry_tpu.models import matcher_data as jmd
from visualodometry_tpu.models import train_matcher as jtm
from visualodometry_tpu.models import train_superpoint as jts
from visualodometry_tpu_torch.models import attention_matcher as tam
from visualodometry_tpu_torch.models import convert, weights
from visualodometry_tpu_torch.models import matcher_data as tmd
from visualodometry_tpu_torch.models import train_matcher as ttm
from visualodometry_tpu_torch.models import train_superpoint as tts
from visualodometry_tpu_torch.models import train_superpoint_textured as ttt

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _assert_batch_equal(port, ref):
    for name, a, b in zip(port._fields, port, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _jbatch(b: ttm.MatchBatch):
    return jtm.MatchBatch(*(jnp.asarray(x.numpy()) for x in b))


def test_generators_are_bit_equal():
    _assert_batch_equal(ttm.synthetic_match_batch(np.random.default_rng(1), batch=3, n=32, d=16),
                        jtm.synthetic_match_batch(np.random.default_rng(1), batch=3, n=32, d=16))
    data = {k: np.array(v) for k, v in jtm.synthetic_match_batch(
        np.random.default_rng(2), batch=4, n=48, d=16)._asdict().items()}
    _assert_batch_equal(tmd.sample_batch(data, np.random.default_rng(3), 3),
                        jmd.sample_batch(data, np.random.default_rng(3), 3))
    data["valid0"][0, :40] = False  # fewer valid slots than n_sub: padding fills
    port = tmd.subsample_slots(data, np.random.default_rng(4), 24)
    ref = jmd.subsample_slots(data, np.random.default_rng(4), 24)
    for k in ref:
        assert port[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def matchers():
    """(port matcher, JAX matcher, JAX params, batch) at depth 2, dim 64."""
    batch = ttm.synthetic_match_batch(np.random.default_rng(5), batch=2, n=32, d=128)
    jmodel = jam.AttentionMatcher(dim=64, heads=4, depth=2, per_layer_heads=True)
    jb = _jbatch(batch)
    params = jmodel.init(jax.random.key(0), jb.kps0[0], jb.desc0[0], jb.valid0[0],
                         jb.kps1[0], jb.desc1[0], jb.valid1[0], method="all_layers")
    rng = np.random.default_rng(6)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    model = tam.AttentionMatcher(desc_dim=128, dim=64, heads=4, depth=2, per_layer_heads=True)
    model.load_state_dict(convert.attention_state_dict_from_flax(params))
    return model, jmodel, jax.tree.map(jnp.asarray, params), batch


def test_all_layers_matches_jax_and_the_2d_call(matchers):
    model, jmodel, jparams, batch = matchers
    jb = _jbatch(batch)
    ref = jax.vmap(lambda *a: jmodel.apply(jparams, *a, method="all_layers"))(
        jb.kps0, jb.desc0, jb.valid0, jb.kps1, jb.desc1, jb.valid1)
    with torch.no_grad():
        outs = model.all_layers(*batch[:6])
        assert len(outs) == 2
        for layer, out in enumerate(outs):
            for a, b in zip(out, ref[layer]):
                b = np.asarray(b)
                assert a.shape == b.shape
                np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max())
        for i in range(2):
            single = model.all_layers(*(x[i] for x in batch[:6]))
            for out, one in zip(outs, single):
                for a, b in zip(out, one):
                    np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-6,
                                               atol=1e-6 * b.abs().max().item())
        sim, m0, m1 = model(*batch[:6])
        for a, b in zip((sim, m0, m1), outs[-1][:3]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_shared_heads_all_layers_gives_unit_confidence():
    model = tam.AttentionMatcher(desc_dim=16, dim=16, heads=2, depth=2)
    model.init_identity_residual(torch.Generator().manual_seed(0))
    b = ttm.synthetic_match_batch(np.random.default_rng(7), batch=2, n=8, d=16)
    with torch.no_grad():
        for sim, m0, m1, c0, c1 in model.all_layers(*b[:6]):
            assert sim.shape == (2, 8, 8) and torch.equal(c0, torch.ones_like(m0))
            assert torch.equal(c1, torch.ones_like(m1))


@pytest.mark.parametrize("deep", [False, True])
def test_matcher_losses_match_jax(matchers, deep):
    model, jmodel, jparams, batch = matchers
    jfn, tfn = (jtm.matcher_loss_deep, ttm.matcher_loss_deep) if deep else (
        jtm.matcher_loss, ttm.matcher_loss)
    loss_j, grads_j = jax.value_and_grad(jfn)(jparams, jmodel, _jbatch(batch))
    loss_t = tfn(model, batch)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_RTOL)
    names = [k for k, _ in model.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()), allow_unused=True)
    state = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(model.named_parameters(), grads_t)}
    assert list(state) == names
    flax_t = convert.attention_flax_from_state_dict(state)["params"]
    g_all = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(grads_j))

    def walk(ref, got, path):
        if "kernel" in ref:
            for part, g in ref.items():
                g = np.asarray(g)
                err = np.abs(got[part] - g).max()
                # floor: the key biases' gradient is zero in exact arithmetic
                # (softmax ignores a constant added to a row), rounding noise
                # on both sides
                assert err <= GRAD_TOL * max(np.abs(g).max(), 1e-4 * g_all), (path, part, err)
            return
        for k in ref:
            walk(ref[k], got[k], path + (k,))

    walk(grads_j["params"], flax_t, ())


def test_evaluate_matches_jax(matchers):
    model, jmodel, jparams, batch = matchers
    got = ttm.evaluate(model, batch, threshold=0.05)
    ref = jtm.evaluate(jparams, jmodel, _jbatch(batch), threshold=0.05)
    assert got == ref and got[1] > 0


@pytest.mark.parametrize("name,heads", [("attention_matcher_sift.pkl", False),
                                        ("attention_matcher_sift_v2.pkl", True)])
def test_matcher_weights_round_trip(tmp_path, name, heads):
    params = weights.load_flax_pickle(weights.bundled(name))
    state = convert.attention_state_dict_from_flax(params)
    back = convert.attention_flax_from_state_dict(state)

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])

    same(back["params"], params["params"])
    model = tam.AttentionMatcher(desc_dim=128, depth=4, per_layer_heads=heads)
    model.load_state_dict(state)
    path = tmp_path / "m.pkl"
    tts.save_params(model, path)
    jparams = jts.load_params(path)
    b = ttm.synthetic_match_batch(np.random.default_rng(8), batch=1, n=16, d=128)
    jb = _jbatch(b)
    jmodel = jam.AttentionMatcher(depth=4, per_layer_heads=heads)
    sim_j = jmodel.apply(jparams, jb.kps0[0], jb.desc0[0], jb.valid0[0], jb.kps1[0],
                         jb.desc1[0], jb.valid1[0])[0]
    with torch.no_grad():
        sim_t = model(*(x[0] for x in b[:6]))[0]
    np.testing.assert_allclose(sim_t.numpy(), np.asarray(sim_j), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(sim_j)).max())


def test_train_matcher_steps():
    model, losses = ttm.train_matcher(steps=3, batch=2, n=16, d=32, depth=2, device="cpu",
                                      log_every=1)
    assert len(losses) == 3 and np.isfinite(losses).all()


# --------------------------------- datasets --------------------------------

HW = (120, 160)
SLOTS = 128


@pytest.fixture(scope="module")
def datasets():
    """(port dataset, JAX dataset) of 2 pairs from seed 9."""
    port = tmd.build_sift_match_dataset(np.random.default_rng(9), n_pairs=2, hw=HW,
                                        n_slots=SLOTS, device="cpu")
    ref = jmd.build_sift_match_dataset(np.random.default_rng(9), n_pairs=2, hw=HW,
                                       n_slots=SLOTS, log_every=0)
    return port, ref


def _pairs(seed, n_pairs, from_jax):
    """`build_sift_match_dataset`'s rendered pairs (base, homography,
    warped view)."""
    from visualodometry_tpu.models import train_superpoint_textured as jtt

    mod = jtt if from_jax else ttt
    rng, (H, W) = np.random.default_rng(seed), HW
    out = []
    for _ in range(n_pairs):
        base = mod._add_polygons(rng, mod._value_noise(rng, H, W))
        Hmat = mod._random_homography(rng, H, W, 0.10)
        out.append((base, Hmat, mod._warp(base, Hmat)))
    return out


def test_sift_dataset_pairs_and_ground_truth_match_jax(datasets):
    _, ref = datasets
    port_pairs, jax_pairs = _pairs(9, 2, False), _pairs(9, 2, True)
    cfg = JaxConfig(extractor_type="sift", max_keypoints=SLOTS, sift_n_features=SLOTS,
                    sift_contrast_threshold=0.02, sift_num_octaves=3, image_size=HW[::-1])
    H, W = HW
    for i, ((base, Hmat, img1), (jbase, jH, jimg1)) in enumerate(zip(port_pairs, jax_pairs)):
        for a, b in ((base, jbase), (Hmat, jH), (img1, jimg1)):
            np.testing.assert_array_equal(a, b)
        f0, f1 = jextract_sift(jnp.asarray(base), cfg), jextract_sift(jnp.asarray(img1), cfg)
        k0, v0 = np.asarray(f0.kps), np.asarray(f0.valid)
        k1, v1 = np.asarray(f1.kps), np.asarray(f1.valid)
        q = (Hmat @ np.concatenate([k0, np.ones((len(k0), 1), np.float32)], axis=1).T).T
        uv = q[:, :2] / np.maximum(np.abs(q[:, 2:]), 1e-9) * np.sign(q[:, 2:])
        inb = v0 & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        gt = tmd.gt_assignment(uv, inb, k1, v1, 3.0)
        np.testing.assert_array_equal(gt, ref["gt_idx"][i])
        assert (gt >= 0).sum() > 10


def test_sift_dataset_agrees_with_jax(datasets):
    port, ref = datasets
    for k in ref:
        assert port[k].shape == ref[k].shape and port[k].dtype == ref[k].dtype, k
    scale = np.array([HW[1], HW[0]], np.float32) / 2.0
    near_all, pairs_all = [], []
    for i in range(2):
        nearest = []
        for side in ("0", "1"):
            kp_t = port["kps" + side][i][port["valid" + side][i]] * scale
            kp_j = ref["kps" + side][i] * scale
            d = np.linalg.norm(kp_j[:, None] - kp_t[None], axis=-1)
            idx_t = np.nonzero(port["valid" + side][i])[0]
            hit = d.min(1) < 0.01
            near_all.append(hit[ref["valid" + side][i]].mean())
            nearest.append(np.where(hit, idx_t[d.argmin(1)], -1))
        jg = ref["gt_idx"][i]
        have = np.nonzero(jg >= 0)[0]
        mapped0, mapped1 = nearest[0][have], nearest[1][jg[have]]
        ok = (mapped0 >= 0) & (mapped1 >= 0)
        pairs_all.append(np.mean(port["gt_idx"][i][mapped0[ok]] == mapped1[ok]) * ok.mean())
    assert min(near_all) >= 0.95, near_all
    assert min(pairs_all) >= 0.85, pairs_all


@pytest.mark.parametrize("which", ["match 512", "match 4096", "vo pool"])
def test_patch_launches_predicts_k2_calls(monkeypatch, which):
    """`sift.patch_launches` gives the (field, slots, window) of every K2
    call of one frame, as chip_smoke.py uses it to hold K2 at the dataset
    functions' shapes: their configurations at a 320x192 frame, the patch
    route forced on the CPU (K2's plain version)."""
    from visualodometry_tpu_torch.data.synthetic import make_scene, render_textured_image
    from visualodometry_tpu_torch.frontend import sift as tsift
    from visualodometry_tpu_torch.models.vo_distill import vo_pool_config

    size = (320, 192)
    scene = make_scene(np.random.default_rng(7), num_frames=1, speed=1.2, turn_rate=0.002,
                       num_landmarks=2, image_size=size)
    img = (np.clip(render_textured_image(scene, 0), 0, 1) * 255 + 0.5).astype(np.uint8)
    cfg = {"match 512": lambda: tmd.match_config(size, 512),
           "match 4096": lambda: tmd.match_config(size, 4096),
           "vo pool": lambda: vo_pool_config(size, 1024)}[which]()
    cfg = dataclasses.replace(cfg, sift_sampling="patch")
    calls = []
    real = tsift.extract_patches

    def record(field, lvl, y0, x0, patch_y, patch_x, **kw):
        calls.append((*field.shape, lvl.shape[0], patch_y, patch_x))
        return real(field, lvl, y0, x0, patch_y, patch_x, **kw)

    monkeypatch.setattr(tsift, "extract_patches", record)
    tsift.extract_sift(torch.as_tensor(img), cfg, device="cpu")
    assert calls and calls == tsift.patch_launches(cfg)
