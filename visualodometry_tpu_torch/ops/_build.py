"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its
own by nvcc into `csrc/build/<name>-<hash>.so` (the hash is of the source,
so an edited kernel rebuilds), then loaded with ctypes. `build_all` starts
one nvcc per source, all at once, and waits for them.

Nothing here runs at import: the CPU-only test machine has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
KERNEL_SOURCES = ("match_top2", "patches", "blur_stack")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (Popen, tmp, out) or None if built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=KERNEL_SOURCES) -> None:
    """Compile every kernel source in parallel (one nvcc each)."""
    started = {n: _start_build(n) for n in names}
    for n, s in started.items():
        _finish_build(n, s)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library for `csrc/<name>.cu`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def current_stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
