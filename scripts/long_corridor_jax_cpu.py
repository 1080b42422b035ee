#!/usr/bin/env python3
"""The JAX package's long-corridor contract, recorded on the CPU.

The reference for chip_smoke.py's long-corridor phase: the bodies of
tests/test_long_sequence.py (`test_reset_recover_and_segment_ate` and
`test_multi_seed_drift_distribution`) at their configuration (`_cfg`:
SIFT at 2048 slots with two orientation peaks, P3P, in-loop BA over 5
keyframes and 1024 landmarks, an 8192-slot landmark ring, the float32
`jnp` matcher) and fixture (`make_long_corridor_fixture` at 640 x 360,
256 frames, a blackout at `blank`), chunks of 8.

Prints one JSON line a seed: the reset frames, the first and last against
`blank`, tracking on the last frame, keyframes, every segment's sim3 ATE
(`segment_ate`), the pre-blackout and final segments, `next_id`, and the
pre-blackout ATE on frames 8:144 (the multi-seed test's window: its whole
chunks before the blackout). Frames 0-143 of a full run are the
multi-seed test's run (the same chunks from the same state), so one full
run a seed serves both tests; `--check-prefix` runs the first seed's 18
chunks again alone and prints whether the positions are bit-equal.

Then one line for the cv2 reference loop (eval/reference_cv2.py, the
tests' `ref_cfg`): `ref_pre` on frames 8:150 and 8:144 of the full run,
and on 8:144 of a run over the first 150 frames (the multi-seed test's
call), with the CRC32 of the uint8 frames. Tracking outcomes only: its
times are CPU times and mean nothing for the port.

    JAX_PLATFORMS=cpu python scripts/long_corridor_jax_cpu.py --seeds 0 1 2 3 4 5 6 7 [--check-prefix]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_FRAMES, CHUNK = 256, 8


def long_corridor_cfg():
    """tests/test_long_sequence.py:_cfg (:60-94), as the test builds it."""
    from visualodometry_tpu.config import VOConfig

    return VOConfig(
        extractor_type="sift", max_keypoints=2048, sift_n_features=2048,
        sift_contrast_threshold=0.02, sift_orientation_peaks=2, sift_num_octaves=3,
        min_median_flow=3.0, max_reproj_err=2.0, pnp_reproj_err=2.0, min_depth=1.0,
        min_parallax_deg=0.35, lowe_ratio=0.75, essential_hypotheses=256,
        pnp_hypotheses=256, pnp_solver="p3p", map_capacity=8192,
        matcher_backend="jnp", ba_window=5, ba_max_landmarks=1024,
    )


def reference_cfg():
    """The tests' `ref_cfg` for the cv2 loop (:141-153, :200-212)."""
    from visualodometry_tpu.config import VOConfig

    return VOConfig(
        extractor_type="sift", max_keypoints=2048, sift_n_features=2048,
        sift_contrast_threshold=0.02, min_median_flow=3.0, max_reproj_err=2.0,
        pnp_reproj_err=2.0, min_depth=1.0, lowe_ratio=0.75, global_scale=1.2,
    )


def run_seed(run, cfg, u8, seed, n_frames):
    import jax
    import jax.numpy as jnp

    from visualodometry_tpu.ba.inloop import init_window
    from visualodometry_tpu.core import init_state

    carry = (init_state(cfg.replace(seed=seed), desc_dim=128), init_window(cfg))
    outs = []
    t0 = time.perf_counter()
    for i in range(0, n_frames, CHUNK):
        carry, out = run(carry, jnp.asarray(u8[i : i + CHUNK]))
        outs.append(jax.tree.map(np.asarray, out))
        print(f"seed {seed} chunk {i // CHUNK}: {time.perf_counter() - t0:.0f} s",
              file=sys.stderr, flush=True)
    return carry[0], outs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--check-prefix", action="store_true")
    ap.add_argument("--no-reference", action="store_true",
                    help="skip the cv2 loop (it runs once, after the seeds)")
    args = ap.parse_args()

    import jax

    from visualodometry_tpu.core.runner import make_chunked_pipeline_fn
    from visualodometry_tpu.data.synthetic import make_long_corridor_fixture, segment_ate
    from visualodometry_tpu.eval import ate_rmse

    u8, gt, K, blank = make_long_corridor_fixture(num_frames=N_FRAMES, image_size=(640, 360))
    b0, b1 = blank
    n_pre = (b0 // CHUNK) * CHUNK
    crc = zlib.crc32(np.ascontiguousarray(u8).tobytes())
    cfg = long_corridor_cfg()
    run = make_chunked_pipeline_fn(cfg, K, enable_ba=True)
    for k, seed in enumerate(args.seeds):
        state, outs = run_seed(run, cfg, u8, seed, N_FRAMES)
        est = np.concatenate([o.T_wc[:, :3, 3] for o in outs])
        resets = np.concatenate([o.did_reset for o in outs])
        inited = np.concatenate([o.initialized for o in outs])
        rf = np.flatnonzero(resets)
        segs = segment_ate(est, gt, resets)
        pre = next((s for s in segs if s[0] == 0), None)
        line = {
            "backend": jax.default_backend(), "seed": seed, "frames": N_FRAMES,
            "blank": [b0, b1], "frames_crc32": crc,
            "reset_frames": rf.tolist(),
            "first_reset_in_blank": bool(len(rf) and b0 <= rf[0] <= b1),
            "last_reset_within_60": bool(len(rf) and rf[-1] <= b1 + 60),
            "initialized_at_end": bool(inited[-1]),
            "keyframes": int(sum(o.is_keyframe.sum() for o in outs)),
            "segments": segs, "segment_pre": pre, "segment_final": segs[-1] if segs else None,
            "next_id": int(state.map.next_id), "map_capacity": cfg.map_capacity,
            "pre_blackout_resets": int(resets[:n_pre].sum()),
            "pre_blackout_ate_8_144": float(ate_rmse(est[8:n_pre], gt[8:n_pre], align="sim3")),
        }
        if args.check_prefix and k == 0:
            _, pouts = run_seed(run, cfg, u8, seed, n_pre)
            pest = np.concatenate([o.T_wc[:, :3, 3] for o in pouts])
            line["prefix_run_bit_equal"] = bool(np.array_equal(pest, est[:n_pre]))
        print(json.dumps(line), flush=True)

    if not args.no_reference:
        from visualodometry_tpu.eval.reference_cv2 import run_reference_pipeline

        Kd = np.asarray(K, np.float64)
        ref_pos, stats = run_reference_pipeline(u8, Kd, reference_cfg())
        ref_pos150, _ = run_reference_pipeline(u8[:b0], Kd, reference_cfg())
        print(json.dumps({
            "reference": "cv2", "frames_crc32": crc, "blank": [b0, b1],
            "resets": stats["resets"], "keyframes": stats["keyframes"],
            "ref_pre_8_150": float(ate_rmse(ref_pos[8:b0], gt[8:b0], align="sim3")),
            "ref_pre_8_144": float(ate_rmse(ref_pos[8:n_pre], gt[8:n_pre], align="sim3")),
            "ref_pre_8_144_first_150": float(
                ate_rmse(ref_pos150[8:n_pre], gt[8:n_pre], align="sim3")),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
