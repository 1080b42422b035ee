"""The benchmark's frozen copies held to their sources at small sizes."""

import numpy as np
import pytest
import torch

from vobench.harness import counts, scene, trace


def test_renderer_is_bit_equal_to_the_ports():
    from visualodometry_tpu_torch.data import synthetic

    a = synthetic.make_scene(np.random.default_rng(7), num_frames=3, speed=1.2,
                             turn_rate=0.002, image_size=(160, 96))
    b = scene.make_scene(np.random.default_rng(7), num_frames=3, speed=1.2,
                         turn_rate=0.002, image_size=(160, 96))
    assert np.array_equal(a.poses_T_wc, b.poses_T_wc) and np.array_equal(a.K, b.K)
    for f in (0, 2):
        ref = synthetic.render_textured_image(a, f)
        assert np.array_equal(ref, scene.render_textured_image(b, f))
        assert np.array_equal(synthetic.render_fixture_u8(a)[f],
                              scene.to_u8(scene.render_textured_image(b, f)))


def test_texture_seeds_change_the_frame():
    s = scene.make_scene(np.random.default_rng(1), num_frames=2, image_size=(96, 64))
    a = scene.render_textured_image(s, 1)
    b = scene.render_textured_image(s, 1, texture_seeds=(1, 2, 3))
    assert not np.array_equal(a, b)


def test_union_arithmetic_is_chip_smokes():
    import chip_smoke

    rng = np.random.default_rng(0)
    starts = rng.uniform(0, 100, 200)
    ranges = list(zip(starts, starts + rng.uniform(0, 5, 200)))
    assert trace.union_us(ranges) == chip_smoke.union_us(ranges)
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4


def test_spans_count_time_frames_and_calls():
    s = trace.Spans(torch.device("cpu"), enabled=True)
    with s.span("step", 4):
        torch.ones(3).sum()
    with s.span("step", 4):
        pass
    got = s.summary()["step"]
    assert got["frames"] == 8 and got["calls"] == 2 and got["syncs"] == 0 and got["seconds"] > 0


def test_k1_and_k2_counts_by_hand():
    flops, nbytes = counts.k1_call(4096, 4000, 128)
    assert flops == 3 * 2 * 4096 * 4000 * 128
    assert nbytes == 4 * 128 * (4096 + 4000) + 4000 + 12 * 4096
    assert counts.k2_call(6, 376, 1280, 100, 72, 64) == 4 * 6 * 376 * 1280 + 100 * (12 + 4 * 72 * 64)
    t, which = counts.least_seconds(flops, nbytes, counts.PEAK_TF32_FLOPS)
    assert which == "operations" and t == pytest.approx(flops / 495e12)


def test_k2_launches_are_the_ports():
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.frontend.sift import patch_launches

    from vobench.harness import spec

    for cell in ("sift_kitti.offline",):
        vo = spec.load_cell(cell).config["vo_config"]
        mine = [x[1:] for x in counts.k2_launches(vo)]
        assert mine == patch_launches(config_from_dict(vo))
        assert counts.octave_slices(vo) == [(0, 2048), (2048, 3072), (3072, 4096)]


def test_superpoint_flops_by_hand():
    # per pixel: conv1a 1152 + conv1b 73728 + (conv2a, 2b) 36864 + conv3a 9216
    # + conv3b 18432 + (conv4a, 4b) 9216 + convDa 9216 + convDb 2048
    # + score1-4 1024 + 256 + 128 + 32 + scoreMixA 9216 + scoreMixB 288
    per_pixel = 170816
    assert counts.superpoint_dense_flops(376, 1232) == per_pixel * 376 * 1232
    assert counts.padded_frame((1226, 370)) == (376, 1232)


def _port_and_reference_configs(name):
    from visualodometry_tpu_torch import config_from_dict as port_cfg

    from vobench.harness import spec
    from vobench.reference.config import config_from_dict as ref_cfg

    vo = dict(spec.load_cell(name).config["vo_config"], image_size=[192, 112],
              max_keypoints=256, sift_n_features=256, map_capacity=2048,
              essential_hypotheses=64, pnp_hypotheses=64, seed=3)
    return port_cfg(vo), ref_cfg(vo)


def test_reference_sift_and_step_equal_the_ports_plain_routes():
    from visualodometry_tpu_torch.core.state import init_state as p_init
    from visualodometry_tpu_torch.core.step import make_step_fn as p_step
    from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn as p_extract

    from vobench.harness.traffic import make_drives
    from vobench.reference.core.state import init_state as r_init
    from vobench.reference.core.step import make_step_fn as r_step
    from vobench.reference.frontend.sift import make_batched_extract_fn as r_extract

    pc, rc = _port_and_reference_configs("sift_kitti.offline")
    d = make_drives({"scene": {"speed": 1.2, "turn_rate": 0.002}, "drive_frames": 4},
                    (192, 112), 5, workers=1)[0]
    imgs = torch.as_tensor(d.frames)
    pf = p_extract(pc, device="cpu")(imgs)
    rf = r_extract(rc, device="cpu")(imgs)
    for a, b in zip(pf, rf):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    ps, pstep = p_init(pc, 128, device="cpu"), p_step(pc, d.K, device="cpu")
    rs, rstep = r_init(rc, 128, device="cpu"), r_step(rc, d.K, device="cpu")
    for a in pf:
        ps, po = pstep(ps, a)
        rs, ro = rstep(rs, a)
        assert all(torch.equal(x, y) for x, y in zip(po, ro))
    assert torch.equal(ps.T_wc, rs.T_wc) and torch.equal(ps.map.points, rs.map.points)


def test_reference_superpoint_equals_the_ports_plain_route():
    from visualodometry_tpu_torch.frontend.superpoint import make_batched_superpoint_extract_fn as p

    from vobench.harness import spec
    from vobench.reference.frontend.superpoint import make_batched_superpoint_extract_fn as r

    pc, rc = _port_and_reference_configs("superpoint_kitti.offline")
    w = spec.ROOT / spec.load_cell("superpoint_kitti.offline").config["weights"]
    imgs = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 112, 192), np.uint8))
    pe, re_ = p(pc, weights_path=str(w), device="cpu"), r(rc, w, device="cpu")
    for a, b in zip(pe(imgs), re_(imgs)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
