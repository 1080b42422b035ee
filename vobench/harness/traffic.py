"""The one traffic generator: drives of corridor frames from a mix's file.

A traffic mix (`vobench/traffic/<mix>.json`) gives the mode of the cell
(`chunked`, `online` or `lanes`), the chunk, the drive's length in frames,
the lanes, and the scene recipe (`make_scene`'s speed and turn rate). The
configuration gives the frame shape. From `--seed`, each lane's drive takes
three texture seeds and the sign of its turn; lane b of a lanes mix is the
drive of seed `lanes * seed + b`. Every seed gives drives of the same
length, shape and speed: only the texture and the turn's side change.

Frames are rendered in set-up, in a pool of spawned worker processes
(numpy only) while the program is imported and built, and the pool is
joined before the window opens.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
import multiprocessing

import numpy as np

from vobench.harness import scene as sc


@dataclass
class Drive:
    frames: np.ndarray  # (F, H, W) uint8
    gt: np.ndarray  # (F, 3) ground-truth camera positions
    K: np.ndarray  # (3, 3)
    seed: int
    texture_seeds: tuple[int, int, int]
    turn_rate: float


def drive_recipe(seed: int, recipe: dict) -> tuple[tuple[int, int, int], float]:
    """The texture seeds and the signed turn rate that `seed` draws."""
    rng = np.random.default_rng(seed)
    tex = tuple(int(s) for s in rng.integers(0, 2**31 - 1, 3))
    sign = 1.0 if rng.integers(0, 2) else -1.0
    return tex, sign * float(recipe["turn_rate"])


def _scene(seed: int, recipe: dict, num_frames: int, image_size) -> sc.Scene:
    _, turn = drive_recipe(seed, recipe)
    return sc.make_scene(
        np.random.default_rng(seed), num_frames=num_frames, speed=float(recipe["speed"]),
        turn_rate=turn, num_landmarks=int(recipe.get("num_landmarks", 2)),
        image_size=tuple(image_size),
    )


def _render(job):
    seed, recipe, num_frames, image_size, frame = job
    tex, _ = drive_recipe(seed, recipe)
    s = _scene(seed, recipe, num_frames, image_size)
    return sc.to_u8(sc.render_textured_image(s, frame, texture_seeds=tex))


def drive_K(image_size) -> np.ndarray:
    """The camera of every drive at this frame shape (`make_scene`'s)."""
    return sc.make_scene(np.random.default_rng(0), num_frames=1, num_landmarks=1,
                         image_size=tuple(image_size)).K


def lane_seeds(seed: int, lanes: int) -> list[int]:
    return [seed] if lanes == 1 else [lanes * seed + b for b in range(lanes)]


def start_drives(traffic: dict, image_size, seed: int, workers: int | None = None):
    """Start rendering one drive per lane in `workers` spawned processes
    (default: the machine's cores, at most 8); returns
    `finish() -> list[Drive]`, which waits for them and joins the pool."""
    recipe, F = traffic["scene"], int(traffic["drive_frames"])
    seeds = lane_seeds(seed, int(traffic.get("lanes", 1)))
    jobs = [(s, recipe, F, tuple(image_size), f) for s in seeds for f in range(F)]
    workers = workers or min(8, os.cpu_count() or 1)
    pool = None
    if workers > 1:
        pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
        pending = pool.map(_render, jobs, chunksize=max(1, len(jobs) // (4 * workers)))

    def finish() -> list[Drive]:
        if pool is None:
            imgs = [_render(j) for j in jobs]
        else:
            with pool:
                imgs = list(pending)
        drives = []
        for i, s in enumerate(seeds):
            scn = _scene(s, recipe, F, image_size)
            tex, turn = drive_recipe(s, recipe)
            drives.append(Drive(np.stack(imgs[i * F:(i + 1) * F]), scn.gt_positions, scn.K, s,
                                tex, turn))
        return drives

    return finish


def make_drives(traffic: dict, image_size, seed: int, workers: int | None = None) -> list[Drive]:
    """One drive per lane (see `start_drives`)."""
    return start_drives(traffic, image_size, seed, workers)()
