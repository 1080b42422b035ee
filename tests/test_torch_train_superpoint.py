"""The port's SuperPoint trainers against the JAX package's on the CPU.

- Batch generators: from the same `np.random.Generator` seed the port's
  numpy generators give bit-equal arrays (synthetic, textured, corridor,
  VO-pair and homography-pool batches; the homography DLT, the warp, the
  Harris and SIFT cell labels).
- Losses: `loss_fn`, `loss_fn_h`, `loss_fn_sub` on the bundled
  `superpoint_vo.pkl` backbone and `loss_fn_dense` on `superpoint_dense.pkl`,
  carried across by the converters, on 2 pairs of 64x96 images: the port in
  float32 against `jax.value_and_grad` of the JAX loss evaluated in float64
  (`jax.enable_x64`, the same weights and batch): each loss and its terms
  within 1e-5 relative, each parameter's gradient within 1e-4 of that
  parameter's largest gradient entry. The reference is float64 because on
  homography pairs, whose warped view has a flat black border, the JAX
  loss's own float32 gradient sits up to 4.3e-3 of the largest entry from
  its float64 value (conv4b, one pair of seeds), where the port's float32
  gradient sits within 2.1e-5: a unit whose pre-activation is near zero
  over the whole flat region flips its ReLU with the summation order.
- Adam with a constant rate, `linear_schedule` and `cosine_decay_schedule`
  against optax on the same given gradients over 6 steps: parameters within
  1e-6 relative (1e-9 absolute); the schedules within 1e-6 relative of
  optax's at every count, read before the increment.
- `init_superpoint` and `warm_start_dense`: the layers, shapes and what is
  copied are JAX's; `save_params` -> JAX `load_params` gives the same
  forward (1e-5); Flax -> torch -> Flax is the identity on the arrays.
- `build_vo_pool` on 1 scene x 2 frames at 192x128: the images bit-equal,
  the SIFT-teacher labels equal on >= 90% of the cells (the two
  frameworks' SIFT differ in float order, so a marginal extremum can
  change a cell's label).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visualodometry_tpu.models import superpoint as jsp
from visualodometry_tpu.models import train_superpoint as jts
from visualodometry_tpu.models import train_superpoint_dense as jtd
from visualodometry_tpu.models import train_superpoint_textured as jtt
from visualodometry_tpu.models import vo_distill as jvd
from visualodometry_tpu_torch.frontend import superpoint as tfront
from visualodometry_tpu_torch.models import convert, optim, weights
from visualodometry_tpu_torch.models import superpoint as tsp
from visualodometry_tpu_torch.models import train_superpoint as tts
from visualodometry_tpu_torch.models import train_superpoint_dense as ttd
from visualodometry_tpu_torch.models import train_superpoint_textured as ttt
from visualodometry_tpu_torch.models import vo_distill as tvd

torch.set_num_threads(2)

HW = (64, 96)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each parameter's largest gradient entry


def _np(x):
    """A port batch (nested NamedTuples of tensors) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return type(x)(*(_np(v) for v in x))


def _assert_batches_equal(port, ref):
    for name, a, b in zip(port._fields, port, ref):
        if hasattr(a, "_fields"):
            _assert_batches_equal(a, b)
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.fixture(scope="module")
def pool():
    """A tiny VO pool, made by the port (SIFT on the CPU): both packages'
    batch generators read the same dict."""
    return tvd.build_vo_pool(np.random.default_rng(3), n_scenes=1, frames_per_scene=3,
                             render_size=(160, 120), sift_slots=128, device="cpu")


def test_synthetic_and_textured_batches_are_bit_equal():
    _assert_batches_equal(tts.synthetic_batch(np.random.default_rng(1), batch=3, hw=HW),
                          jts.synthetic_batch(np.random.default_rng(1), batch=3, hw=HW))
    _assert_batches_equal(ttt.textured_batch(np.random.default_rng(2), batch=3, hw=HW),
                          jtt.textured_batch(np.random.default_rng(2), batch=3, hw=HW))


def test_corridor_batch_is_bit_equal():
    crops = ttt.corridor_crop_pool(np.random.default_rng(4), n_scenes=1, frames_per_scene=2,
                                   render_size=(160, 120))
    assert len(crops) == 2 and crops[0].shape == (120, 160)
    _assert_batches_equal(ttt.corridor_batch(np.random.default_rng(5), crops, batch=3, hw=HW),
                          jtt.corridor_batch(np.random.default_rng(5), crops, batch=3, hw=HW))


def test_pool_batches_are_bit_equal(pool):
    for fn, jfn in ((tvd.vo_pair_batch, jvd.vo_pair_batch),
                    (tvd.homography_pool_batch, jvd.homography_pool_batch)):
        _assert_batches_equal(fn(np.random.default_rng(6), pool, batch=3, hw=HW),
                              jfn(np.random.default_rng(6), pool, batch=3, hw=HW))


def test_synthesis_helpers_are_bit_equal():
    for seed in range(3):
        H = ttt._random_homography(np.random.default_rng(seed), 48, 64, 0.12)
        np.testing.assert_array_equal(H, jtt._random_homography(np.random.default_rng(seed),
                                                                48, 64, 0.12))
        img = ttt._add_polygons(np.random.default_rng(seed),
                                ttt._value_noise(np.random.default_rng(seed), 48, 64))
        ref = jtt._add_polygons(np.random.default_rng(seed),
                                jtt._value_noise(np.random.default_rng(seed), 48, 64))
        np.testing.assert_array_equal(img, ref)
        np.testing.assert_array_equal(ttt._warp(img, H), jtt._warp(ref, H))
        np.testing.assert_array_equal(ttt._harris_cell_labels(img), jtt._harris_cell_labels(ref))
        rng = np.random.default_rng(seed)
        kps = rng.uniform(0, [64, 48], (40, 2)).astype(np.float32)
        resp = rng.normal(size=40).astype(np.float32)
        for a, b in zip(tvd.sift_cell_labels(kps, resp, 48, 64),
                        jvd.sift_cell_labels(kps, resp, 48, 64)):
            np.testing.assert_array_equal(a, b)


# --------------------------------- losses ---------------------------------


def _jax64(jfn, jmodel, params, batch):
    """(loss, aux, grads) of the JAX loss in float64, as numpy."""
    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)

    reduce_window = jax.lax.reduce_window

    def typed_reduce_window(operand, init_value, *args, **kwargs):
        # the dense loss's dilation takes a Python 0.0 as the init of a
        # float32 operand, which x64 mode would make float64
        return reduce_window(operand, np.asarray(init_value, operand.dtype), *args, **kwargs)

    with jax.enable_x64(True), mock.patch.object(jax.lax, "reduce_window", typed_reduce_window):
        p64 = jax.tree.map(f64, params)
        b64 = jax.tree.map(f64, _np(batch))
        (loss, aux), grads = jax.value_and_grad(jfn, has_aux=True)(p64, jmodel, b64)
        return float(loss), [float(a) for a in aux], jax.tree.map(np.asarray, grads)


def _check_loss(jfn, tfn, name, batch):
    """The port's loss and gradients (float32) against the JAX loss's in
    float64 on the same weights and batch."""
    params = weights.load_flax_pickle(weights.bundled(name))
    jmodel = jsp.SuperPointDense() if tsp.is_dense_params(params) else jsp.SuperPointBackbone()
    model = tfront.load_superpoint(weights_path=weights.bundled(name))[0]
    loss_j, aux_j, grads_j = _jax64(jfn, jmodel, params, batch)
    loss_t, aux_t = tfn(model, batch)
    assert len(aux_t) == len(aux_j)
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=LOSS_RTOL)
    for a, b in zip(aux_t, aux_j):
        np.testing.assert_allclose(a.item(), b, rtol=LOSS_RTOL)
    names = [k for k, _ in model.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, list(model.parameters()))
    flax_t = convert.superpoint_flax_from_state_dict(dict(zip(names, grads_t)))["params"]
    for layer, leaves in grads_j["params"].items():
        for part, g in leaves.items():
            err = np.abs(flax_t[layer][part] - g).max()
            assert err <= GRAD_TOL * np.abs(g).max(), (layer, part, err, np.abs(g).max())


def test_loss_fn_matches_jax():
    batch = tts.synthetic_batch(np.random.default_rng(7), batch=2, hw=HW)
    _check_loss(jts.loss_fn, tts.loss_fn, "superpoint_vo.pkl", batch)


def test_loss_fn_h_matches_jax():
    batch = ttt.textured_batch(np.random.default_rng(8), batch=2, hw=HW)
    _check_loss(jtt.loss_fn_h, ttt.loss_fn_h, "superpoint_vo.pkl", batch)


def test_loss_fn_sub_matches_jax(pool):
    batch = tvd.vo_pair_batch(np.random.default_rng(9), pool, batch=2, hw=HW)
    _check_loss(jvd.loss_fn_sub, tvd.loss_fn_sub, "superpoint_vo.pkl", batch)


@pytest.mark.parametrize("kind", ["vo_pair", "homography"])
def test_loss_fn_dense_matches_jax(pool, kind):
    fn = tvd.vo_pair_batch if kind == "vo_pair" else tvd.homography_pool_batch
    batch = fn(np.random.default_rng(10), pool, batch=2, hw=HW)
    assert int(batch.subv0.sum()) > 10
    _check_loss(jtd.loss_fn_dense, ttd.loss_fn_dense, "superpoint_dense.pkl", batch)


def test_detection_bce_duplicate_pixel_keeps_positive():
    """Two keypoints rounding to one pixel, one valid and one not: the
    pixel stays a positive whichever is written last (scatter-max)."""
    score = torch.zeros(1, 16, 16)
    pos = torch.tensor([[[5.2, 7.1], [4.9, 6.8]]])
    for valid in ([[True, False]], [[False, True]]):
        v = torch.tensor(valid)
        got = ttd._detection_bce(score, pos, v)
        ref = jtd._detection_bce(jnp.zeros((1, 16, 16)), jnp.asarray(pos.numpy()),
                                 jnp.asarray(v.numpy()))
        np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_RTOL)


# ------------------------------- optimizer --------------------------------


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_adam_and_schedules_match_optax(schedule):
    steps, lr = 6, 1e-2
    sched_t, sched_j = {
        "constant": (lr, lr),
        "linear": (optim.linear_schedule(lr, lr * 0.1, steps),
                   optax.linear_schedule(lr, lr * 0.1, steps)),
        "cosine": (optim.cosine_decay_schedule(lr, steps, alpha=0.05),
                   optax.cosine_decay_schedule(lr, steps, alpha=0.05)),
    }[schedule]
    if schedule != "constant":
        for count in range(steps + 3):
            np.testing.assert_allclose(sched_t(count), float(sched_j(count)), rtol=1e-6)
    rng = np.random.default_rng(11)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params_t = [torch.tensor(p) for p in p0]
    opt = optim.Adam(params_t, sched_t)
    tx = optax.adam(sched_j)
    params_j = [jnp.asarray(p) for p in p0]
    state = tx.init(params_j)
    for _ in range(steps):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        opt.step([torch.tensor(x) for x in g])
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params_j)
        params_j = optax.apply_updates(params_j, upd)
        for a, b in zip(params_t, params_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
        for a, b in zip(opt.exp_avg, state[0].mu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert opt.count == steps


# ------------------------- init, warm start, weights ----------------------


def test_init_superpoint_has_jax_layers_and_scale():
    model = tsp.init_superpoint(torch.Generator().manual_seed(0), (64, 96), device="cpu")
    _, jparams = jsp.init_superpoint(jax.random.key(0), (64, 96))
    tree = convert.superpoint_flax_from_state_dict(model.state_dict())["params"]
    assert tree.keys() == jparams["params"].keys()
    for layer, leaves in jparams["params"].items():
        k_j, k_t = np.asarray(leaves["kernel"]), tree[layer]["kernel"]
        assert k_t.shape == k_j.shape
        np.testing.assert_array_equal(tree[layer]["bias"], np.asarray(leaves["bias"]))
        if k_j.size >= 4096:  # LeCun normal: std 1 / sqrt(fan_in) on both sides
            np.testing.assert_allclose(k_t.std(), k_j.std(), rtol=0.1)


def test_warm_start_dense_copies_what_jax_copies():
    src = weights.load_flax_pickle(weights.bundled("superpoint_vo.pkl"))
    model = ttd.warm_start_dense(torch.Generator().manual_seed(0), src, device="cpu")
    _, jparams = jtd.warm_start_dense(jax.random.key(0), jax.tree.map(jnp.asarray, src), (64, 96))
    tree = convert.superpoint_flax_from_state_dict(model.state_dict())["params"]
    assert tree.keys() == jparams["params"].keys()
    for layer, leaves in jparams["params"].items():
        copied_j = layer in src["params"] and np.array_equal(
            np.asarray(leaves["kernel"]), src["params"][layer]["kernel"])
        copied_t = layer in src["params"] and np.array_equal(
            tree[layer]["kernel"], src["params"][layer]["kernel"])
        assert copied_t == copied_j, layer
        assert tree[layer]["kernel"].shape == np.asarray(leaves["kernel"]).shape


@pytest.mark.parametrize("name", ["superpoint_vo.pkl", "superpoint_dense.pkl"])
def test_flax_torch_flax_is_the_identity(name):
    params = weights.load_flax_pickle(weights.bundled(name))
    back = convert.superpoint_flax_from_state_dict(convert.superpoint_state_dict_from_flax(params))
    assert back["params"].keys() == params["params"].keys()
    for layer, leaves in params["params"].items():
        for part, a in leaves.items():
            assert back["params"][layer][part].dtype == np.float32
            np.testing.assert_array_equal(back["params"][layer][part], a)


def test_save_params_reads_back_in_jax(tmp_path):
    model = tsp.init_superpoint(torch.Generator().manual_seed(1), device="cpu")
    path = tmp_path / "sp.pkl"
    tts.save_params(model, path)
    jparams = jts.load_params(path)
    img = np.random.default_rng(12).random((1, 64, 96), dtype=np.float32)
    det_j, desc_j = jsp.SuperPointBackbone().apply(jparams, jnp.asarray(img)[..., None])
    with torch.no_grad():
        det_t, desc_t = model(torch.from_numpy(img)[:, None])
    np.testing.assert_allclose(det_t.permute(0, 2, 3, 1).numpy(), np.asarray(det_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(desc_t.permute(0, 2, 3, 1).numpy(), np.asarray(desc_j),
                               rtol=1e-5, atol=1e-5)
    # the port's own reader (numpy arrays only) takes the file too
    again = tfront.load_superpoint(weights_path=path)[0]
    for a, b in zip(again.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


def test_pretrainers_step_and_fall():
    _, losses = tts.pretrain(steps=4, batch=2, hw=(96, 128), device="cpu", log_every=1)
    assert len(losses) == 4 and np.isfinite(losses).all() and losses[-1] < losses[0]
    _, log = ttt.pretrain_textured(steps=3, batch=2, hw=(48, 64), device="cpu", log_every=1)
    assert [r[0] for r in log] == [0, 1, 2] and np.isfinite(np.array(log)).all()


def test_build_vo_pool_matches_jax():
    kw = dict(n_scenes=1, frames_per_scene=2, render_size=(192, 128), sift_slots=256)
    port = tvd.build_vo_pool(np.random.default_rng(13), device="cpu", **kw)
    ref = jvd.build_vo_pool(np.random.default_rng(13), **kw)
    for key in ("imgs", "depth", "T_wc", "scene_id", "K"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
    same = (port["labels"] == ref["labels"]).mean()
    have = (ref["labels"] != 64).mean()
    assert have > 0.05 and same >= 0.90, (same, have)
