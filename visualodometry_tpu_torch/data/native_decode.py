"""ctypes binding for the native C++ decoder (native/decoder.cpp, jpeg.cpp).

Port of visualodometry_tpu/data/native_decode.py with its own copy of the
sources. The library is built at first use, never at import, by g++ into
`csrc/build/libvodecode-<hash>.so` (the hash is of both sources, so an
edited source rebuilds; the build writes a temporary name and renames it
into place, so processes that build at once do not see a partial file):

    image_info(path) -> (W, H)
    decode_gray(path) -> (H, W) float32 in [0, 1]
    decode_batch(paths, w, h, threads) -> ((N, H, W) float32, n_ok)

A failed build raises with the compiler's output: it never turns into the
PIL path. PIL (imported lazily) decodes only a file that the native parser
rejects, in `decode_gray`; `routes` counts the frames each route decoded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE = Path(__file__).resolve().parent.parent / "native"
SOURCES = (_NATIVE / "decoder.cpp", _NATIVE / "jpeg.cpp")
BUILD_DIR = _NATIVE.parent / "csrc" / "build"

# frames decoded by each route since the last reset (callers zero it)
routes = {"native": 0, "pil": 0}
_lib = None
_lib_lock = threading.Lock()  # one build per process (the prefetch thread may ask too)


def _lib_path() -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in SOURCES)).hexdigest()[:12]
    return BUILD_DIR / f"libvodecode-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", *map(str, SOURCES), "-o", str(tmp),
           "-lz", "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native decoder: cannot run g++: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native decoder: g++ failed ({proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed; raises if it
    cannot be built."""
    global _lib
    with _lib_lock:
        if _lib is None:
            out = _lib_path()
            if not out.exists():
                _build(out)
            _lib = _bind(ctypes.CDLL(str(out)))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    lib.vo_image_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
    lib.vo_image_info.restype = ctypes.c_int
    lib.vo_decode_gray.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_int, ctypes.c_int]
    lib.vo_decode_gray.restype = ctypes.c_int
    lib.vo_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, c_float_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.vo_decode_batch.restype = ctypes.c_int
    return lib


def image_info(path: str | Path) -> tuple[int, int]:
    """(W, H) of a PNG/PGM/baseline-JPEG file via the native parser."""
    lib = get_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.vo_image_info(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"cannot parse header of {path} (rc={rc})")
    return w.value, h.value


def _decode_pil(path) -> np.ndarray:
    from visualodometry_tpu_torch.data.prefetch import decode_grayscale

    routes["pil"] += 1
    return decode_grayscale(path)


def decode_gray(path: str | Path) -> np.ndarray:
    """Native decode; PIL for a file the native parser rejects."""
    lib = get_lib()
    try:
        w, h = image_info(path)
    except ValueError:
        return _decode_pil(path)
    out = np.empty((h, w), np.float32)
    rc = lib.vo_decode_gray(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h
    )
    if rc != 0:
        return _decode_pil(path)
    routes["native"] += 1
    return out


def decode_batch(paths, w: int, h: int, threads: int | None = None) -> tuple[np.ndarray, int]:
    """Parallel native decode of uniform-size frames -> ((N, H, W), n_ok).

    A frame that fails to decode (or is not w x h) is zero-filled and not
    counted in n_ok, as in the JAX package."""
    lib = get_lib()
    n = len(paths)
    threads = threads or min(os.cpu_count() or 4, 16)
    out = np.empty((n, h, w), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    n_ok = lib.vo_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h, threads
    )
    routes["native"] += n_ok
    return out, n_ok
