"""The port's multi-sequence step (parallel/multiseq.py) and its pieces vs
the JAX package, on the CPU.

- K1's plain version with a lane axis against `jax.vmap` of the Pallas
  matcher in interpret mode (ratio outcomes, as tests/test_torch_match.py
  holds the 2-D call: that kernel forms bf16 products) and against its own
  2-D calls lane by lane (exactly).
- Lane b of the port's multi-sequence step equals the port's single step
  run alone on lane b's features with lane b's generator, exactly, on
  frames where the lanes take different branches; the same with the
  attention matcher (which loops over the lanes).
- The port against JAX's `make_multiseq_step_fn` on the 8-device CPU mesh,
  with JAX's per-lane draws, the JAX state resynced to the port's before
  every frame as tests/test_distributed.py's five-point test resyncs it:
  the same branch outcomes per lane, rotation within 2 degrees and
  translation within 10% of the motion scale. A JAX batched state carried
  into the port steps on like the JAX step.
- `make_chunked_step_fn` against the JAX package's on one lane.

The JAX comparisons pin `essential_solver="8point"`, as
tests/test_distributed.py's parity test does, with 2 lanes, 128 slots and
32 + 32 hypotheses: the vmapped JAX step's compile is the cost of this file.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualodometry_tpu.config import VOConfig as JaxConfig
from visualodometry_tpu.core import state as jstate_mod
from visualodometry_tpu.core.runner import make_chunked_step_fn as jchunked
from visualodometry_tpu.data.synthetic import make_scene as jmake_scene
from visualodometry_tpu.data.synthetic import render_features as jrender
from visualodometry_tpu.estimation.ransac import sample_valid_indices as jsample
from visualodometry_tpu.ops.match_pallas import match_top2_pallas
from visualodometry_tpu.parallel import make_mesh as jmake_mesh
from visualodometry_tpu.parallel.multiseq import init_batched_state as jinit_batched
from visualodometry_tpu.parallel.multiseq import make_multiseq_step_fn as jmultiseq
from visualodometry_tpu_torch.config import config_from_dict
from visualodometry_tpu_torch.core import (
    init_state,
    make_chunked_step_fn,
    make_step_fn,
    state_from_numpy,
    state_to_numpy,
)
from visualodometry_tpu_torch.core.state import lane_state, stack_states
from visualodometry_tpu_torch.core.step import generator_sampler
from visualodometry_tpu_torch.data.synthetic import make_scene, render_features
from visualodometry_tpu_torch.frontend.interface import Features
from visualodometry_tpu_torch.frontend.matcher import match_descriptors
from visualodometry_tpu_torch.ops import match_top2 as mt
from visualodometry_tpu_torch.parallel import init_batched_state, make_multiseq_step_fn

torch.set_num_threads(2)

K = np.array([[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]], np.float32)


def _cfgs(n_slots, hyp, **kw):
    jc = JaxConfig(
        extractor_type="synthetic", max_keypoints=n_slots, sift_n_features=n_slots,
        min_median_flow=3.0, pnp_reproj_err=2.0, essential_hypotheses=hyp,
        pnp_hypotheses=hyp, map_capacity=1024, **kw,
    )
    return jc, config_from_dict(dataclasses.asdict(jc))


def _t(x):
    return torch.as_tensor(np.array(x))


def _lane_sets(rng, B, n0=256, n1=384, d=128, n_pairs=120):
    d0 = rng.normal(size=(B, n0, d)).astype(np.float32)
    d1 = rng.normal(size=(B, n1, d)).astype(np.float32)
    base = rng.normal(size=(B, n_pairs, d)).astype(np.float32)
    d0[:, :n_pairs] = base + 0.05 * rng.normal(size=base.shape)
    d1[:, :n_pairs] = base + 0.05 * rng.normal(size=base.shape)
    d0 /= np.linalg.norm(d0, axis=-1, keepdims=True)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return d0, d1, rng.random((B, n0)) > 0.05, rng.random((B, n1)) > 0.1


def test_top2_lanes_match_per_lane_calls_and_vmapped_pallas():
    rng = np.random.default_rng(0)
    B = 3
    d0, d1, valid0, valid1 = _lane_sets(rng, B)
    b_t, s_t, i_t = mt.match_top2(_t(d0), _t(d1), _t(valid1))
    assert b_t.shape == s_t.shape == i_t.shape == (B, 256) and i_t.dtype == torch.int32
    for b in range(B):
        one = mt.match_top2(_t(d0[b]), _t(d1[b]), _t(valid1[b]))
        for x, y in zip((b_t[b], s_t[b], i_t[b]), one):
            assert torch.equal(x, y)
    b_p, s_p, i_p = (np.asarray(x) for x in jax.vmap(
        lambda a, c, v: match_top2_pallas(a, c, v, interpret=True))(
        jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(valid1)))
    assert b_p.shape == (B, 256)
    r_t = match_descriptors(_t(d0), _t(valid0), _t(d1), _t(valid1), ratio=0.8)
    ok_p = valid0 & (b_p < 0.64 * s_p)
    ok_t = r_t.valid.numpy()
    margin = np.abs(b_p - 0.64 * s_p) > 5e-3 * s_p
    np.testing.assert_array_equal(ok_t[margin], ok_p[margin])
    both = ok_t & ok_p
    np.testing.assert_array_equal(r_t.idx.numpy()[both], i_p[both])
    assert ok_t[:, :120].mean() > 0.8


@pytest.mark.parametrize("mutual", [False, True])
def test_match_descriptors_lanes_equal_per_lane(mutual):
    d0, d1, valid0, valid1 = _lane_sets(np.random.default_rng(1), 2)
    r = match_descriptors(_t(d0), _t(valid0), _t(d1), _t(valid1), ratio=0.8, mutual=mutual)
    for b in range(2):
        one = match_descriptors(_t(d0[b]), _t(valid0[b]), _t(d1[b]), _t(valid1[b]),
                                ratio=0.8, mutual=mutual)
        assert torch.equal(r.idx[b], one.idx) and torch.equal(r.valid[b], one.valid)


def test_top2_lane_checks():
    d = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError):
        mt.match_top2(d, torch.zeros(3, 4, 8), torch.ones(3, 4, dtype=torch.bool))
    with pytest.raises(ValueError):
        mt.match_top2(d, d, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        mt.match_top2(d, d[0], torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize(
    "n0,n1,lanes,want",
    [
        (4096, 4096, 1, 4),  # the 2-D main path: unchanged
        (4096, 4096, 2, 2),
        (4096, 4096, 4, 1),  # four lanes of 32 query tiles fill 128 SMs
        (2048, 2048, 4, 2),
        (128, 4096, 8, 16),
        (4096, 4096, 64, 1),  # more tiles than SMs: never 0
    ],
)
def test_match_top2_splits_with_lanes(n0, n1, lanes, want):
    """The split count at B lanes: query tiles x splits x lanes fills the
    132 SMs once and no more, so the scratch (3 x lanes x splits x N0
    words) stays small."""
    s = mt._splits(n0, n1, 132, lanes)
    assert s == want
    assert s == 1 or -(-n0 // 128) * lanes * s <= 132


def _port_feat_seqs(B, n_slots, frames, seed0):
    seqs = []
    for b in range(B):
        rng_b = np.random.default_rng(seed0 + b)
        scene = make_scene(rng_b, num_frames=frames, speed=1.2, num_landmarks=1500)
        seqs.append([render_features(scene, f, n_slots, rng_b, pixel_noise=0.2, device="cpu")
                     for f in range(frames)])
    return seqs


def _lanes_equal_single(cfg, seqs, frames, desc_dim=128):
    """Step every lane with the multi-sequence step and alone with the
    single step on the same generator seed; every output and the final
    state must be equal. Returns the set of (frame, branch kinds)."""
    B = len(seqs)
    mstep = make_multiseq_step_fn(cfg, K, device="cpu")
    ms = init_batched_state(cfg, desc_dim, B, device="cpu")
    # lane b's draws from a generator seeded cfg.seed + b; the matcher (the
    # attention matcher's random init is seeded with cfg.seed) as the lanes'
    singles = [
        make_step_fn(cfg, K, device="cpu",
                     sampler=generator_sampler(torch.Generator().manual_seed(cfg.seed + b)))
        for b in range(B)
    ]
    ss = [init_state(cfg, desc_dim, device="cpu") for _ in range(B)]
    kinds = []
    for f in range(frames):
        ms, mo = mstep(ms, [seqs[b][f] for b in range(B)])
        row = set()
        for b in range(B):
            prev_init = bool(ss[b].initialized)
            ss[b], so = singles[b](ss[b], seqs[b][f])
            for name, x, y in zip(so._fields, so, lane_state(mo, b)):
                assert torch.equal(x, y), (f, b, name)
            row.add("reset" if bool(so.did_reset) else "track" if prev_init else "init")
        kinds.append(row)
    for b in range(B):
        for x, y in zip(jax.tree.leaves(state_to_numpy(ss[b])),
                        jax.tree.leaves(state_to_numpy(lane_state(ms, b)))):
            np.testing.assert_array_equal(x, y)
    return kinds


def test_multiseq_lanes_equal_single_steps():
    """B = 3, 256 slots, the default five-point solver. Lane 2 sees another
    scene's features at frame 3, so it resets there while the other lanes
    track, and re-initialises after: the lanes take different branches in
    one frame."""
    _, tc = _cfgs(256, 64)
    frames = 6
    seqs = _port_feat_seqs(3, 256, frames, 200)
    seqs[2][3] = _port_feat_seqs(1, 256, 4, 999)[0][3]
    kinds = _lanes_equal_single(tc, seqs, frames)
    assert any(len(k) >= 2 for k in kinds), kinds
    assert {"reset", "track"} <= set().union(*kinds)


def test_multiseq_attention_lanes_equal_single_steps():
    """The attention matcher (no lane axis: it loops over the lanes) at a
    small size: 2 lanes, 128 slots, depth 1, its seeded random init."""
    _, tc = _cfgs(128, 32, matcher_type="attention", attention_depth=1)
    seqs = _port_feat_seqs(2, 128, 4, 300)
    kinds = _lanes_equal_single(tc, seqs, 4)
    assert "track" in set().union(*kinds)


def test_multiseq_keeps_its_lane_count_and_samplers():
    _, tc = _cfgs(128, 32)
    seqs = _port_feat_seqs(2, 128, 1, 400)
    mstep = make_multiseq_step_fn(tc, K, device="cpu")
    ms, _ = mstep(init_batched_state(tc, 128, 2, device="cpu"), [s[0] for s in seqs])
    assert [g.initial_seed() for g in mstep.generators] == [tc.seed, tc.seed + 1]
    with pytest.raises(ValueError, match="lanes"):
        mstep(init_batched_state(tc, 128, 3, device="cpu"), [seqs[0][0]] * 3)
    with pytest.raises(ValueError, match="samplers"):
        make_multiseq_step_fn(tc, K, device="cpu", samplers=[None])(ms, [s[0] for s in seqs])


# --- against the JAX package -------------------------------------------------

B_JAX = 2
FRAMES_JAX = 5


def _jax_state(d: dict, keys):
    """A JAX batched VOState from the port's (state_to_numpy) and keys."""
    return jstate_mod.VOState(
        **{k: jnp.asarray(v) for k, v in d.items() if k not in ("keyframe", "map")},
        keyframe=jstate_mod.Keyframe(**{k: jnp.asarray(v) for k, v in d["keyframe"].items()}),
        map=jstate_mod.MapState(**{k: jnp.asarray(v) for k, v in d["map"].items()}),
        rng_key=keys,
    )


def _to_port_feats(f) -> Features:
    return Features(*(torch.as_tensor(np.array(x)) for x in f))


class _JaxDraws:
    """Per-lane samplers that draw as the JAX step does: lane b's key is
    split into (key, k_ess, k_pnp) once a frame (`advance`)."""

    def __init__(self, keys):
        self.keys = keys
        self.frame = None

    def advance(self):
        split = jax.vmap(lambda k: jax.random.split(k, 3))(self.keys)
        self.keys, self.frame = split[:, 0], split

    def sampler(self, b: int):
        def draw(valid, num_hypotheses, sample_size):
            k = self.frame[b, 1] if sample_size in (5, 8) else self.frame[b, 2]
            idx = jsample(k, jnp.asarray(valid.numpy()), num_hypotheses, sample_size)
            return torch.as_tensor(np.array(idx)).long()

        return draw


@pytest.fixture(scope="module")
def jax_ref():
    jc, tc = _cfgs(128, 32, essential_solver="8point")
    feats = []
    for b in range(B_JAX):
        rng_b = np.random.default_rng(200 + b)
        scene = jmake_scene(rng_b, num_frames=FRAMES_JAX, speed=1.2, num_landmarks=1500)
        feats.append([jrender(scene, f, 128, rng_b, pixel_noise=0.2) for f in range(FRAMES_JAX)])
    batch = [jax.tree.map(lambda *xs: jnp.stack(xs), *[fs[f] for fs in feats])
             for f in range(FRAMES_JAX)]
    mesh = jmake_mesh(num_seq=B_JAX, num_map=8 // B_JAX)
    jstep = jmultiseq(jc, jnp.asarray(K), mesh)
    state = jinit_batched(jc, 128, B_JAX)
    states, outs = [state], []
    for f in range(FRAMES_JAX):
        state, out = jstep(state, batch[f])
        states.append(state)
        outs.append(jax.tree.map(np.asarray, out))
    return dict(jc=jc, tc=tc, feats=feats, batch=batch, jstep=jstep, states=states, outs=outs)


def _behaviour(out_j, out_t, b, f):
    """Same branch outcome; rotation within 2 degrees, translation within
    10% of the motion scale (tests/test_distributed.py's cone). Returns
    whether the lane was tracking (and so the cone was checked)."""
    assert bool(out_t.initialized[b]) == bool(out_j.initialized[b]), (f, b)
    assert bool(out_t.did_reset[b]) == bool(out_j.did_reset[b]), (f, b)
    if not bool(out_j.initialized[b]):
        return False
    T_t, T_j = out_t.T_wc[b].numpy(), np.asarray(out_j.T_wc[b])
    cos = (np.trace(T_t[:3, :3].T @ T_j[:3, :3]) - 1.0) / 2.0
    assert np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) < 2.0, (f, b)
    scale = max(np.linalg.norm(T_j[:3, 3]), 1.0)
    assert np.linalg.norm(T_t[:3, 3] - T_j[:3, 3]) < 0.1 * scale, (f, b)
    return True


def test_multiseq_matches_jax_vmapped_step(jax_ref):
    """Resynced each frame: the JAX step is given the port's state, and
    both step the same features with the same per-lane JAX draws."""
    draws = _JaxDraws(jinit_batched(jax_ref["jc"], 128, B_JAX).rng_key)
    tstep = make_multiseq_step_fn(
        jax_ref["tc"], K, device="cpu", samplers=[draws.sampler(b) for b in range(B_JAX)]
    )
    state = init_batched_state(jax_ref["tc"], 128, B_JAX, device="cpu")
    checked = 0
    for f in range(FRAMES_JAX):
        _, out_j = jax_ref["jstep"](_jax_state(state_to_numpy(state), draws.keys),
                                   jax_ref["batch"][f])
        draws.advance()
        state, out_t = tstep(state, [_to_port_feats(fs[f]) for fs in jax_ref["feats"]])
        checked += sum(_behaviour(out_j, out_t, b, f) for b in range(B_JAX))
    assert checked >= B_JAX * 2  # the cone check ran on tracking frames


def test_jax_batched_state_carried_into_port(jax_ref):
    """The JAX batched state after frame 2 (both lanes tracking), carried
    in by `state_from_numpy`, stepped by the port on frames 3-4 with the
    JAX keys it carries: each lane as the JAX run."""
    st = jax_ref["states"][3]
    assert np.asarray(st.initialized).all()
    np_state = jax.tree.map(np.asarray, st._replace(rng_key=None))
    state = state_from_numpy(np_state, device="cpu")
    assert state.T_wc.shape == (B_JAX, 4, 4)
    draws = _JaxDraws(st.rng_key)
    tstep = make_multiseq_step_fn(
        jax_ref["tc"], K, device="cpu", samplers=[draws.sampler(b) for b in range(B_JAX)]
    )
    for f in (3, 4):
        draws.advance()
        state, out_t = tstep(state, [_to_port_feats(fs[f]) for fs in jax_ref["feats"]])
        for b in range(B_JAX):
            assert _behaviour(jax_ref["outs"][f], out_t, b, f)


def test_chunked_step_matches_jax(jax_ref):
    """`make_chunked_step_fn` on lane 0's frames as one chunk, with the JAX
    engine's draws, against the JAX package's `make_chunked_step_fn`: the
    same flags and match counts on every frame, rotations within 1e-3 and
    positions within 1e-3 of the distance travelled. The eight-point init's
    linear refit solves a float32 9 x 9 normal matrix, whose null vector
    two operation orders give to ~1e-3
    (test_torch_estimation.py::test_eight_point_system_and_solve_match_jax):
    the init's direction differs by ~3e-4 rad, and the positions after it
    by that fraction of the path."""
    jc, tc = jax_ref["jc"], jax_ref["tc"]
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *jax_ref["feats"][0])
    _, out_j = jchunked(jc, jnp.asarray(K))(jstate_mod.init_state(jc, 128), stack)
    out_j = jax.tree.map(np.asarray, out_j)
    draws = _JaxDraws(jstate_mod.init_state(jc, 128).rng_key[None])
    run = make_chunked_step_fn(tc, K, device="cpu", sampler=draws.sampler(0))

    def frames():  # the JAX key chain advances once a frame
        for f in jax_ref["feats"][0]:
            draws.advance()
            yield _to_port_feats(f)

    _, out_t = run(init_state(tc, 128, device="cpu"), frames())
    assert out_t.T_wc.shape == (FRAMES_JAX, 4, 4)
    for name in ("initialized", "is_keyframe", "did_reset"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(), getattr(out_j, name))
    np.testing.assert_array_equal(out_t.num_matches.numpy(), out_j.num_matches)
    assert out_j.initialized.sum() >= 3
    T_t = out_t.T_wc.numpy()
    np.testing.assert_allclose(T_t[:, :3, :3], out_j.T_wc[:, :3, :3], atol=1e-3)
    travelled = np.linalg.norm(out_j.T_wc[:, :3, 3], axis=-1)
    assert (np.linalg.norm(T_t[:, :3, 3] - out_j.T_wc[:, :3, 3], axis=-1)
            <= 1e-3 * np.maximum(travelled, 1.0)).all()


def test_chunked_step_takes_stacked_features():
    """A stacked `Features` chunk steps as its frames one by one."""
    _, tc = _cfgs(128, 32)
    seq = _port_feat_seqs(1, 128, 4, 500)[0]
    _, out_s = make_chunked_step_fn(tc, K, device="cpu")(
        init_state(tc, 128, device="cpu"), stack_states(seq))
    _, out_l = make_chunked_step_fn(tc, K, device="cpu")(init_state(tc, 128, device="cpu"), seq)
    for x, y in zip(out_s, out_l):
        assert torch.equal(x, y)
    assert bool(out_s.initialized[-1])
