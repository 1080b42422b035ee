"""The port's SuperPoint frontend vs the JAX package on the CPU.

Both architectures with their bundled weights, carried across by the
port's converter: the dense scoring head (`superpoint_dense.pkl`) and the
cell-softmax head (`superpoint_vo.pkl`), on a rendered 96x160 corridor
frame.

- Network outputs: float32 within 1e-4 of the largest value (sums in
  another order); bf16 within two bf16 steps at the largest value (2^-6
  relative; the two frameworks round at the same places, but accumulate
  in other orders).
- Post-processing on the same float32 heads: the same valid keypoint set,
  positions within 1e-4 px, descriptors within 1e-5.
- Whole extraction: float32 gives the same keypoint set (positions within
  1e-3 px); bf16 keeps >= 95% of the JAX keypoints within 0.1 px (slots
  near the threshold may flip between implementations).
- The learned path end to end through `make_chunked_pipeline_fn` and
  `VOEngine` on a 640x192, 12-frame fixture against the JAX runner:
  resets, init frame, keyframe flags within one frame, sim3 ATE within
  0.01 m of JAX's.
"""

import collections
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualodometry_tpu.config import get_config as jget_config
from visualodometry_tpu.core import init_state as jinit
from visualodometry_tpu.core.runner import make_chunked_pipeline_fn as jpipeline
from visualodometry_tpu.eval import ate_rmse as jate
from visualodometry_tpu.frontend import superpoint as jfront
from visualodometry_tpu.models import superpoint as jsp
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.core import VOEngine, init_state, make_chunked_pipeline_fn
from visualodometry_tpu_torch.data.synthetic import make_scene, render_fixture_u8
from visualodometry_tpu_torch.eval import ate_rmse
from visualodometry_tpu_torch.frontend import superpoint as tfront
from visualodometry_tpu_torch.models import convert, weights
from visualodometry_tpu_torch.models import superpoint as tsp

torch.set_num_threads(2)

ARCHS = {"dense": "superpoint_dense.pkl", "cell": "superpoint_vo.pkl"}
DTYPES = {"float32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SLOTS = 512


def _frame(size=(160, 96), n=1):
    scene = make_scene(np.random.default_rng(7), num_frames=n, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=size)
    return render_fixture_u8(scene)


@pytest.fixture(scope="module")
def img():
    return _frame()[0].astype(np.float32) / 255.0


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request):
    """(name, Flax params, JAX module, port module with converted weights)."""
    path = weights.bundled(ARCHS[request.param])
    params = weights.load_flax_pickle(path)
    dense = request.param == "dense"
    assert tsp.is_dense_params(params) == dense == jsp.is_dense_params(params)
    model = tsp.SuperPointDense() if dense else tsp.SuperPointBackbone()
    model.load_state_dict(convert.superpoint_state_dict_from_flax(params))
    jmodel = jsp.SuperPointDense() if dense else jsp.SuperPointBackbone()
    return request.param, jax.tree.map(jnp.asarray, params), jmodel, model.eval()


def _jax_heads(jmodel, params, img, dt):
    p = jax.tree.map(lambda a: a.astype(dt), params)
    det, desc = jmodel.apply(p, jnp.asarray(img)[None, :, :, None].astype(dt))
    return np.array(det.astype(jnp.float32))[0], np.array(desc.astype(jnp.float32))[0]


def _jax_heat(name, det):
    det = jnp.asarray(det)
    return jax.nn.sigmoid(det) if name == "dense" else jsp.heatmap_from_logits(det)


def _threshold(name):
    cfg = jget_config("kitti", extractor="superpoint")
    return cfg.superpoint_dense_threshold if name == "dense" else cfg.superpoint_threshold


def _valid_kps(f):
    kps, valid = (np.asarray(x) for x in (f.kps, f.valid))
    return kps[valid], np.asarray(f.desc)[valid]


def _nearest(a, b):
    """For each row of a, the distance to and index of the nearest row of b."""
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return d.min(axis=1), d.argmin(axis=1)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_network_matches_jax(arch, img, dtype):
    name, params, jmodel, model = arch
    dt_j, dt_t = DTYPES[dtype]
    det_j, desc_j = _jax_heads(jmodel, params, img, dt_j)
    with torch.no_grad():
        det, desc = model(torch.as_tensor(img)[None, None].to(dt_t))
    det = det.float().numpy()[0]
    if name == "cell":
        det = det.transpose(1, 2, 0)
    desc = desc.float().numpy()[0].transpose(1, 2, 0)
    assert det.shape == det_j.shape and desc.shape == desc_j.shape == (12, 20, 256)
    tol = 1e-4 if dtype == "float32" else 2.0**-6
    scale = np.abs(det_j).max()
    assert np.abs(det - det_j).max() <= tol * scale, (np.abs(det - det_j).max(), scale)
    assert np.abs(desc - desc_j).max() <= tol


def test_heatmap_from_logits_matches_jax():
    logits = np.random.default_rng(0).normal(size=(3, 5, 65)).astype(np.float32) * 4
    want = np.asarray(jsp.heatmap_from_logits(jnp.asarray(logits)))
    got = tsp.heatmap_from_logits(torch.as_tensor(logits)).numpy()
    assert got.shape == (24, 40)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # batched form: each frame as alone
    two = tsp.heatmap_from_logits(torch.as_tensor(np.stack([logits, logits[::-1]])))
    np.testing.assert_array_equal(two[0].numpy(), got)


def test_nms_heatmap_matches_jax():
    """Quantised values, so plateaus (ties) occur; the border is padded with
    -inf, so edge pixels compare only against pixels inside."""
    heat = np.round(np.random.default_rng(1).random((40, 56)) * 8).astype(np.float32) / 8
    want = np.asarray(jsp.nms_heatmap(jnp.asarray(heat)))
    got = tsp.nms_heatmap(torch.as_tensor(heat)).numpy()
    np.testing.assert_array_equal(got, want)
    batch = tsp.nms_heatmap(torch.as_tensor(np.stack([heat, heat])))
    np.testing.assert_array_equal(batch[1].numpy(), want)


@pytest.mark.parametrize("forstner", [False, True])
def test_select_keypoints_matches_jax(arch, img, forstner):
    name, params, jmodel, _ = arch
    det, desc = _jax_heads(jmodel, params, img, jnp.float32)
    thr = _threshold(name)
    want = jsp.select_keypoints(
        _jax_heat(name, det), jnp.asarray(desc), SLOTS, thr,
        img=jnp.asarray(img) if forstner else None,
    )
    heat = torch.sigmoid(torch.as_tensor(det)) if name == "dense" else \
        tsp.heatmap_from_logits(torch.as_tensor(det))
    got = tsp.select_keypoints(
        heat, torch.as_tensor(desc), SLOTS, thr, img=torch.as_tensor(img) if forstner else None
    )
    (kj, dj), (kt, dt) = _valid_kps(want), _valid_kps(got)
    assert len(kj) == len(kt) >= 50
    dist, idx = _nearest(kt, kj)
    assert dist.max() <= 1e-4
    assert len(set(idx.tolist())) == len(kj)
    np.testing.assert_allclose(dt, dj[idx], atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_extraction_matches_jax(arch, img, dtype):
    """`make_superpoint_extract_fn` on one frame. bf16 against the JAX
    package's own `superpoint_extract` (bf16 backbone); float32 against the
    same chain with the JAX network run in float32."""
    name, params, jmodel, _ = arch
    cfg = config_from_dict(dataclasses.asdict(jget_config("kitti", extractor="superpoint")))
    cfg = cfg.replace(max_keypoints=SLOTS, sift_n_features=SLOTS)
    thr = _threshold(name)
    if dtype == "bf16":
        want = jsp.superpoint_extract(jmodel, params, jnp.asarray(img), SLOTS, thr)
    else:
        det, desc = _jax_heads(jmodel, params, img, jnp.float32)
        want = jsp.select_keypoints(_jax_heat(name, det), jnp.asarray(desc), SLOTS, thr)
    extract = tfront.make_superpoint_extract_fn(
        cfg, weights_path=weights.bundled(ARCHS[name]), device="cpu",
        compute_dtype=DTYPES[dtype][1],
    )
    got = extract(torch.as_tensor(img))
    assert got.kps.shape == (SLOTS, 2) and got.desc.shape == (SLOTS, 256)
    direct = tsp.superpoint_extract(extract.model, torch.as_tensor(img), SLOTS, thr,
                                    compute_dtype=DTYPES[dtype][1])
    assert all(torch.equal(a, b) for a, b in zip(direct, got))
    (kj, dj), (kt, dt) = _valid_kps(want), _valid_kps(got)
    dist, idx = _nearest(kj, kt)
    if dtype == "float32":
        assert len(kj) == len(kt) and dist.max() <= 1e-3
        np.testing.assert_allclose(dt[idx], dj, atol=1e-4)
    else:
        close = dist <= 0.1
        assert close.mean() >= 0.95 and abs(len(kt) - len(kj)) <= 0.05 * len(kj), (
            close.mean(), len(kt), len(kj))
        cos = np.sum(dt[idx[close]] * dj[close], axis=1)
        assert np.median(cos) >= 0.999 and cos.min() >= 0.99


def test_pad_to_multiple_matches_jax():
    img = np.random.default_rng(2).random((90, 157)).astype(np.float32)
    want = np.asarray(jfront._pad_to_multiple(jnp.asarray(img)))
    got = tfront._pad_to_multiple(torch.as_tensor(img))
    assert got.shape == (96, 160)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tfront._pad_to_multiple(torch.zeros(2, 96, 160)).shape == (2, 96, 160)


def test_default_weights_and_threshold_follow_the_architecture():
    assert tfront._default_weights_path().name == jfront._default_weights_path().name
    cfg = config_from_dict(dataclasses.asdict(jget_config("kitti", extractor="superpoint")))
    extract = tfront.make_superpoint_extract_fn(cfg, device="cpu")
    assert isinstance(extract.model, tsp.SuperPointDense)
    cell = tfront.make_superpoint_extract_fn(
        cfg, weights_path=weights.bundled("superpoint_vo.pkl"), device="cpu"
    )
    assert isinstance(cell.model, tsp.SuperPointBackbone)


def test_random_init_without_weights(monkeypatch):
    """No weight file: a cell-head network with LeCun-normal kernels drawn
    from the seed (as JAX's random init, not its numbers)."""
    monkeypatch.setattr(tfront, "_default_weights_path", lambda: None)
    a, dense = tfront.load_superpoint(seed=3)
    b, _ = tfront.load_superpoint(seed=3)
    c, _ = tfront.load_superpoint(seed=4)
    assert not dense and isinstance(a, tsp.SuperPointBackbone)
    assert torch.equal(a.conv3b.weight, b.conv3b.weight)
    assert not torch.equal(a.conv3b.weight, c.conv3b.weight)
    assert abs(float(a.conv3b.weight.detach().std()) - (9 * 128) ** -0.5) < 2e-3
    assert not a.conv3b.bias.any()


def test_torch_checkpoint_and_weight_reader(tmp_path):
    """A lightglue-style .pth (prefixed keys) loads with the prefix
    stripped; a missing layer raises; the weight reader refuses a file that
    names anything but numpy arrays."""
    state = convert.superpoint_state_dict_from_flax(
        weights.load_flax_pickle(weights.bundled("superpoint_vo.pkl"))
    )
    torch.save({"superpoint." + k: v for k, v in state.items()}, tmp_path / "sp.pth")
    back = convert.load_torch_superpoint(str(tmp_path / "sp.pth"))
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    model, dense = tfront.load_superpoint(checkpoint_path=str(tmp_path / "sp.pth"))
    assert not dense and torch.equal(model.convDb.weight, state["convDb.weight"])
    del state["convPb.bias"]
    torch.save(state, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="convPb.bias"):
        convert.load_torch_superpoint(str(tmp_path / "bad.pth"))
    with open(tmp_path / "evil.pkl", "wb") as f:
        pickle.dump({"params": collections.OrderedDict()}, f)
    with pytest.raises(pickle.UnpicklingError, match="only numpy arrays"):
        weights.load_flax_pickle(tmp_path / "evil.pkl")


# ---- the SuperPoint path end to end ---------------------------------------

SIZE = (640, 192)
CHUNK = 4
FRAMES = 12


@pytest.fixture(scope="module")
def sp_ref():
    """The JAX runner on the SuperPoint path (bench.py's superpoint stage:
    `get_config("kitti", "superpoint")` with the scene-matched gates and
    Lowe 0.92) over a 640x192, 12-frame corridor; slots, hypotheses and map
    cut for the CPU."""
    scene = make_scene(np.random.default_rng(7), num_frames=FRAMES, speed=1.2,
                       turn_rate=0.002, num_landmarks=2, image_size=SIZE)
    u8 = render_fixture_u8(scene)
    jc = jget_config("kitti", extractor="superpoint").replace(
        min_median_flow=3.0, max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0,
        lowe_ratio=0.92, min_parallax_deg=0.35, matcher_backend="jnp",
        max_keypoints=SLOTS, sift_n_features=SLOTS, essential_hypotheses=128,
        pnp_hypotheses=128, map_capacity=4096, image_size=SIZE,
    )
    run = jpipeline(jc, scene.K)
    state = jinit(jc, desc_dim=256)
    outs = []
    for i in range(0, FRAMES, CHUNK):
        state, out = run(state, jnp.asarray(u8[i : i + CHUNK]))
        outs.append(jax.tree.map(np.asarray, out))
    out = jax.tree.map(lambda *xs: np.concatenate(xs), *outs)
    return dict(scene=scene, u8=u8, tc=config_from_dict(dataclasses.asdict(jc)), out=out)


def _assert_tracks_like_jax(T, kf, resets, init, ref):
    out_j, gt = ref["out"], ref["scene"].gt_positions
    assert T.shape == (FRAMES, 4, 4) and np.isfinite(T).all()
    assert resets.sum() == out_j.did_reset.sum() == 0
    assert np.argmax(init) == np.argmax(out_j.initialized)
    assert (kf != out_j.is_keyframe).sum() <= 1
    ate_t = ate_rmse(T[8:, :3, 3], gt[8:], align="sim3")
    ate_j = jate(out_j.T_wc[8:, :3, 3], gt[8:], align="sim3")
    assert ate_j < 0.05 and abs(ate_t - ate_j) <= 0.01, (ate_t, ate_j)


def test_superpoint_path_tracks_like_jax(sp_ref):
    run = make_chunked_pipeline_fn(sp_ref["tc"], sp_ref["scene"].K, device="cpu")
    assert isinstance(run.extract.model, tsp.SuperPointDense)
    state = init_state(sp_ref["tc"], desc_dim=256, device="cpu")
    outs = []
    for i in range(0, FRAMES, CHUNK):
        state, out = run(state, sp_ref["u8"][i : i + CHUNK])
        outs.append(out)
    _assert_tracks_like_jax(
        *(torch.cat([getattr(o, k) for o in outs]).numpy()
          for k in ("T_wc", "is_keyframe", "did_reset", "initialized")), sp_ref
    )


def test_engine_with_superpoint_and_checkpoint(sp_ref, tmp_path):
    """`VOEngine` with the SuperPoint extractor (256-D state) tracks like the
    JAX runner, and resumes from a checkpoint at frame 6 bit for bit."""
    tc, K, u8 = sp_ref["tc"], sp_ref["scene"].K, sp_ref["u8"]
    whole = VOEngine(K, tc, device="cpu")
    assert whole.desc_dim == 256 and whole.state.keyframe.desc.shape == (SLOTS, 256)
    outs = [whole.process_frame(img) for img in u8]
    _assert_tracks_like_jax(
        *(np.stack([getattr(o, k) for o in outs])
          for k in ("T_wc", "is_keyframe", "did_reset", "initialized")), sp_ref
    )
    first = VOEngine(K, tc, device="cpu")
    for img in u8[:6]:
        first.process_frame(img)
    first.save_state(tmp_path / "sp.npz")
    resumed = VOEngine(K, tc, device="cpu")
    resumed.load_state(tmp_path / "sp.npz")
    for j, img in enumerate(u8[6:], start=6):
        for a, b in zip(resumed.process_frame(img), outs[j]):
            np.testing.assert_array_equal(a, b)
