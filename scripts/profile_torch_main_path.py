#!/usr/bin/env python3
"""Where the port's main path spends its time on one NVIDIA GPU.

Run from the root of a checkout:
    python3 scripts/profile_torch_main_path.py [--path main|kitti_gates]
                                               [--pyramid-impl auto|pallas]

`--path main` (default): the bench configuration (chip_smoke.BENCH_CFG) on
the 32-frame textured fixture. `--path kitti_gates`: chip_smoke's
KITTI-gates configuration on frames 96-151 of its marathon fixture (the
blackout at 120-123 included), so reset, re-bootstrap and init frames are
in the counts. `--pyramid-impl` is handed to the pipeline. After one
warm-up pass:
  - wall time per frame of the whole pass, of the batched extraction
    alone, and of the VO step alone (host clock, synchronised);
  - host synchronisations per frame in extraction and in the step (every
    synchronising CUDA call, counted under torch.cuda.set_sync_debug_mode);
  - a torch.profiler trace of one tracking chunk: device busy time over
    the wall time of the chunk (the profiler slows the host, so that wall
    time is longer than an unprofiled one), and the operators that take
    the most device time;
  - with `--path kitti_gates`, the host synchronisations of the step frame
    by frame, grouped by what the frame did.

Prints the card's name and power limit beside the numbers. Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("main", "kitti_gates"), default="main")
    ap.add_argument("--pyramid-impl", choices=("auto", "pallas"), default="auto")
    args = ap.parse_args()
    impl = args.pyramid_impl

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from visualodometry_tpu_torch import config_from_dict
    from visualodometry_tpu_torch.core import init_state, make_chunked_pipeline_fn
    from visualodometry_tpu_torch.core.step import make_step_fn
    from visualodometry_tpu_torch.data.synthetic import (
        make_marathon_fixture,
        make_scene,
        render_fixture_u8,
    )
    from visualodometry_tpu_torch.frontend.sift import make_batched_extract_fn
    from visualodometry_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build_all()
    dev = torch.device("cuda", 0)
    if args.path == "main":
        scene = make_scene(np.random.default_rng(7), num_frames=cs.N_FRAMES, speed=1.2,
                           turn_rate=0.002, image_size=cs.IMG_SIZE)
        u8, K = render_fixture_u8(scene), scene.K
        cfg = config_from_dict(cs.BENCH_CFG)
    else:
        first, last = 96, 152
        u8, _, K, _ = make_marathon_fixture(num_frames=last, blanks=(cs.GATES_BLANK,))
        u8 = u8[first:]
        cfg = cs.gates_config()
    n = len(u8)
    chunks = [torch.as_tensor(u8[i : i + cs.CHUNK]).to(dev) for i in range(0, n, cs.CHUNK)]
    print(f"path {args.path}, pyramid_impl {impl}, {n} frames", flush=True)

    def full_pass():
        run = make_chunked_pipeline_fn(cfg, K, device=dev, pyramid_impl=impl)
        st = init_state(cfg, desc_dim=128, device=dev)
        for c in chunks:
            st, _ = run(st, c)
        torch.cuda.synchronize()

    full_pass()  # warm-up: kernels loaded, band matrices on the device
    t0 = time.perf_counter()
    full_pass()
    t_pass = time.perf_counter() - t0

    extract = make_batched_extract_fn(cfg, device=dev, pyramid_impl=impl)
    step = make_step_fn(cfg, K, device=dev)
    t_ext = t_step = 0.0
    st = init_state(cfg, desc_dim=128, device=dev)
    feats_by_chunk = []
    for c in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = extract(c)
        torch.cuda.synchronize()
        t_ext += time.perf_counter() - t0
        feats_by_chunk.append(feats)
        t0 = time.perf_counter()
        for f in feats:
            st, _ = step(st, f)
        torch.cuda.synchronize()
        t_step += time.perf_counter() - t0

    # host synchronisations per frame: every synchronising CUDA call
    # warns under sync debug mode; count the warnings, and their source
    # lines, over a fresh run
    import collections
    import warnings

    syncs = {"extract": 0, "step": 0}
    sites = collections.Counter()
    per_frame = []  # (step syncs, output) of every frame
    step = make_step_fn(cfg, K, device=dev)
    st = init_state(cfg, desc_dim=128, device=dev)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for c in chunks:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                feats = extract(c)
            syncs["extract"] += len(caught)
            for f in feats:
                with warnings.catch_warnings(record=True) as caught_f:
                    warnings.simplefilter("always")
                    st, out = step(st, f)
                syncs["step"] += len(caught_f)
                per_frame.append((len(caught_f), out))
                caught += caught_f
            sites.update(
                f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
            )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if args.path == "kitti_gates":
        kinds = collections.defaultdict(list)
        was_init = False
        for k, out in per_frame:
            reset, init = bool(out.did_reset), bool(out.initialized)
            kind = ("reset" if reset else "tracking" if was_init and init
                    else "initialized" if init else "bootstrap or waiting for init")
            kinds[kind].append(k)
            was_init = init
        print("step synchronisations by frame kind (count of frames: syncs of each): "
              + "; ".join(f"{kind} {len(v)}: {sorted(set(v))}" for kind, v in kinds.items()),
              flush=True)
    print(f"host synchronisations: extraction {syncs['extract'] / n:.2f}/frame, "
          f"step {syncs['step'] / n:.2f}/frame; by source line over {n} frames: "
          f"{dict(sites.most_common(12))}", flush=True)

    print(f"pass: {1e3 * t_pass / n:.2f} ms/frame ({n / t_pass:.3f} frames/s); "
          f"extraction {1e3 * t_ext / n:.2f} ms/frame; step {1e3 * t_step / n:.2f} "
          f"ms/frame; on {card}",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    run = make_chunked_pipeline_fn(cfg, K, device=dev, pyramid_impl=impl)
    st = init_state(cfg, desc_dim=128, device=dev)
    st, _ = run(st, chunks[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, _ = run(st, chunks[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in events])
    if busy_us > 0:
        print(f"profiled chunk 2 (8 tracking frames): wall {1e3 * wall:.1f} ms, device "
              f"busy {busy_us / 1e3:.1f} ms ({100 * busy_us / (1e6 * wall):.1f}%), "
              f"{len(events)} device events; on {card}", flush=True)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
        print(table, flush=True)
    else:
        print("profiled chunk 2: the profiler recorded no device time "
              "(device busy share not measured)", flush=True)
    return 0


def _union_us(ranges) -> float:
    """Total length of the union of [start, end) intervals (microseconds)."""
    total = 0.0
    end_max = None
    for s, e in sorted(ranges):
        if end_max is None or s > end_max:
            total += e - s
            end_max = e
        elif e > end_max:
            total += e - end_max
            end_max = e
    return total


if __name__ == "__main__":
    sys.exit(main())
