#!/usr/bin/env python3
"""The JAX package's CLI on the CPU over chip_smoke.py's KITTI tree.

The reference for the limits of chip_smoke.py's CLI phase: the 32-frame
textured corridor at 1226 x 370 (seed 7, speed 1.2, the main path's
frames) written as kitti/05/image_0/%06d.png with kitti/poses/05.txt,
then `visualodometry_tpu.cli.main` with `--platform cpu` and the --set
list that turns `get_config("kitti", "sift")` into chip_smoke.py's
BENCH_CFG, with the float32 `jnp` matcher in place of the Pallas one
(which has no CPU mode outside interpret):

- `chunked`: `--chunk 8`, once (cfg.seed 0);
- `klt`: `--tracker klt` at each `--seeds` value (cfg.seed, the RANSAC
  key; 0-3 by default): the KLT path's ATE is set by the draws.

`--package torch` runs the port's CLI (`visualodometry_tpu_torch.cli`,
`--platform cpu`, chip_smoke.cli_overrides()) over the same tree instead,
for its CPU outcome beside the reference.

Prints one JSON line per run: the CLI's own result line (frames, fps,
ate_xz_sim3) with the package, mode and seed. Tracking outcomes only:
its times are CPU times and mean nothing for the port.

    JAX_PLATFORMS=cpu python scripts/cli_jax_cpu.py [--stage chunked|klt] [--seeds 0 1 2 3]
        [--package jax|torch]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=("chunked", "klt"), action="append")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    args = ap.parse_args()

    from chip_smoke import (BENCH_CFG, CHUNK, CLI_SEQUENCE, IMG_SIZE, N_FRAMES,
                            cli_overrides, write_kitti_tree)
    from visualodometry_tpu import cli
    from visualodometry_tpu.config import VOConfig, get_config
    from visualodometry_tpu.data.synthetic import make_scene, render_textured_image

    scene = make_scene(np.random.default_rng(7), num_frames=N_FRAMES, speed=1.2,
                       turn_rate=0.002, image_size=IMG_SIZE)
    imgs = np.stack([render_textured_image(scene, f) for f in range(N_FRAMES)])
    u8 = (np.clip(imgs, 0, 1) * 255 + 0.5).astype(np.uint8)  # as the bench fixture

    base_cfg = get_config("kitti", extractor="sift")
    want = VOConfig(**{**BENCH_CFG, "matcher_backend": "jnp"})
    sets = []
    for f in dataclasses.fields(want):
        if getattr(want, f.name) != getattr(base_cfg, f.name):
            sets += ["--set", f"{f.name}={getattr(want, f.name)}"]
    assert cli._apply_overrides(base_cfg, sets[1::2]) == want
    if args.package == "torch":
        from visualodometry_tpu_torch import cli

        sets = cli_overrides()

    tmp = tempfile.mkdtemp(prefix="vo_cli_jax_")
    try:
        write_kitti_tree(tmp, u8, scene.gt_positions)
        base = ["--dataset", "kitti", "--path", tmp, "--sequence", CLI_SEQUENCE,
                "--platform", "cpu", *sets]
        runs = []
        for stage in args.stage or ("chunked", "klt"):
            if stage == "chunked":
                runs.append(("chunked", 0, ["--chunk", str(CHUNK)]))
            else:
                runs += [("klt", s, ["--tracker", "klt", "--set", f"seed={s}"])
                         for s in args.seeds]
        for mode, seed, extra in runs:
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(base + extra)
            res = json.loads(buf.getvalue().strip().splitlines()[-1])
            print(json.dumps({"package": args.package, "mode": mode, "seed": seed, "rc": rc, **res,
                              "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
