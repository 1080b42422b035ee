"""Prefetching host ingest: decode ahead, overlap with device work.

Port of visualodometry_tpu/data/prefetch.py. It replaces the reference's
synchronous in-loop `cv2.imread` (reference: src/main.py:58-64) with a
background thread that decodes frames `depth` ahead of the consumer, so
disk and decode latency hide behind device compute.

Unlike the JAX module, a decode error in the worker is raised to the
consumer (not ended silently), and the worker also stops when the consumer
breaks off while the queue is full.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

_POLL_S = 0.05  # how often a blocked worker looks for the consumer's stop


def decode_grayscale(path: Path | str) -> np.ndarray:
    """Decode an image file to float32 grayscale in [0, 1] (PIL)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("L")
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return arr


def decode_auto(path: Path | str) -> np.ndarray:
    """The native C++ decoder (PNG/PGM/baseline JPEG); PIL for the files it
    rejects."""
    from visualodometry_tpu_torch.data import native_decode

    return native_decode.decode_gray(path)


class _Failed:
    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class PrefetchLoader:
    """Iterate decoded frames with a bounded look-ahead queue.

    A daemon worker thread decodes ahead; `__iter__` yields in order.
    `depth` bounds memory (depth x frame bytes).
    """

    def __init__(
        self,
        paths: Iterable[Path | str],
        depth: int = 4,
        decode=decode_auto,
    ) -> None:
        self.paths = list(paths)
        self.depth = depth
        self.decode = decode

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for p in self.paths:
                    if not put(self.decode(p)):
                        return
                put(done)
            except Exception as e:  # handed to the consumer, which raises it
                put(_Failed(e))

        t = threading.Thread(target=worker, name="prefetch-worker", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, _Failed):
                    raise item.exc
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)
