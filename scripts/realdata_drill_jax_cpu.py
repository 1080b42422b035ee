#!/usr/bin/env python3
"""The JAX package's CLI at the reference's KITTI gate set, on the CPU.

The reference for the gate-set run of chip_smoke.py's CLI phase: the tree
of tests/test_realdata_drill.py (32 frames at 1226 x 370, scene seed 7,
speed 2.4, two point landmarks, turn rate 0.002) rendered with the value
noise texture named explicitly (`texture="noise"`: the photo texture
needs matplotlib, which the card's machine lacks), written as
kitti/05/image_0/%06d.png with kitti/poses/05.txt, then the CLI's default
per-frame engine with `--platform cpu`, `get_config("kitti", "sift")`
(`min_median_flow=40`, `pnp_reproj_err=1`, P3P) and only the drill's two
overrides, `sift_edge_threshold=10` and `global_scale=2.4`, at each
`--seeds` value (cfg.seed, the RANSAC key).

`--package torch` runs the port's CLI over the same tree instead, for its
CPU outcome beside the reference.

Prints the uint8 frames' CRC32, then one JSON line a seed: the CLI's own
result line (frames, fps, ate_xz_sim3, the last only when at least 8
poses were tracked). Tracking outcomes only: its times are CPU times and
mean nothing for the port.

    JAX_PLATFORMS=cpu python scripts/realdata_drill_jax_cpu.py [--seeds 0 1 ...]
        [--package jax|torch]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    args = ap.parse_args()

    from chip_smoke import (CLI_SEQUENCE, DRILL_FRAMES, DRILL_SCENE, DRILL_SETS,
                            write_kitti_tree)

    if args.package == "torch":
        from visualodometry_tpu_torch import cli
        from visualodometry_tpu_torch.data.synthetic import make_scene, render_textured_image
    else:
        from visualodometry_tpu import cli
        from visualodometry_tpu.data.synthetic import make_scene, render_textured_image

    scene = make_scene(np.random.default_rng(7), num_frames=DRILL_FRAMES, **DRILL_SCENE)
    imgs = np.stack([render_textured_image(scene, f, texture="noise")
                     for f in range(DRILL_FRAMES)])
    u8 = (np.clip(imgs, 0, 1) * 255 + 0.5).astype(np.uint8)  # as the drill's tree
    crc = zlib.crc32(np.ascontiguousarray(u8).tobytes())
    print(json.dumps({"frames_crc32": crc, "shape": list(u8.shape)}), flush=True)

    tmp = tempfile.mkdtemp(prefix="vo_drill_")
    try:
        write_kitti_tree(tmp, u8, scene.gt_positions)
        base = ["--dataset", "kitti", "--path", tmp, "--sequence", CLI_SEQUENCE,
                "--extractor", "sift", "--platform", "cpu",
                "--max-frames", str(DRILL_FRAMES), *DRILL_SETS]
        for seed in args.seeds:
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(base + ["--set", f"seed={seed}"])
            res = json.loads(buf.getvalue().strip().splitlines()[-1])
            print(json.dumps({"package": args.package, "seed": seed, "rc": rc, **res,
                              "frames_crc32": crc,
                              "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
