#!/usr/bin/env python3
"""Where K3's time goes: the kernel with one of its parts taken out, on one card.

    python3 scripts/k3_time_split.py

Builds `visualodometry_tpu_torch/csrc/blur_stack.cu` as it is and four
copies, each with one part disabled (the outputs of those are wrong; they
only time what is left): the next tile's copy under the vertical pass, the
stores of the results, the horizontal pass, the vertical pass. Then times
each build at the KITTI-gates path's five launch shapes (B = 8) with
chip_smoke.py's device timer, in turns, and prints one JSON line per shape.
The unmodified build is first held against the plain version (1e-5).
The copies are made by replacing lines of the source; if the source has
changed so that a line is gone, the script stops and names it.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from visualodometry_tpu_torch.ops import _build  # noqa: E402
from visualodometry_tpu_torch.ops import pyramid as py  # noqa: E402

# (what is taken out, line of the source, its replacement)
PARTS = {
    "no_next_tile_copy": ("    load_tile<TP, TH>(in_s, base, tn, RA, H, W, vec);",
                          "    if (RA < 0) load_tile<TP, TH>(in_s, base, tn, RA, H, W, vec);"),
    "no_stores": ("  if (gx >= W) return;",
                  "  if (gx >= W || acc[0][0] != 1234.5f) return;"),
    "no_horizontal": ("  horizontal<TP, TH>(in_s, h_s, w);",
                      "  if (RA < 0) horizontal<TP, TH>(in_s, h_s, w);"),
    "no_vertical": ("  vertical<TP, TH>(h_s, out",
                    "  if (RA < 0) vertical<TP, TH>(h_s, out"),
}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_variants(tmp: str) -> dict:
    src = (_build.CSRC / "blur_stack.cu").read_text()
    sources = {"as_built": src}
    for name, (line, replacement) in PARTS.items():
        if src.count(line) != 1:
            raise SystemExit(f"{name}: the line {line.strip()!r} is not in the source once")
        sources[name] = src.replace(line, replacement)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"{name}.so")
        procs[name] = (so, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.blur_stack_launch.restype = ctypes.c_int
        lib.blur_stack_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_time_split: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build_variants(tmp)
        for C, H, W in cs.GATES_BLUR_SHAPES:
            g = torch.Generator(device=dev).manual_seed(C * 100003 + H * 1009 + W)
            img = torch.rand(cs.CHUNK, H, W, generator=g, device=dev)
            out = torch.empty(cs.CHUNK, C, H, W, device=dev)
            taps = cs._blur_taps(C, H)
            packed, RA = py._pack_taps(taps)

            def call(lib):
                err = lib.blur_stack_launch(
                    img.data_ptr(), packed.ctypes.data, out.data_ptr(), cs.CHUNK, C,
                    packed.shape[1], RA, H, W, torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed with error {err}")

            call(libs["as_built"])
            ref = py._blur_stack_torch(img, torch.tensor(taps, device=dev))
            err = float((out - ref).abs().max())
            if err > 1e-5:
                raise AssertionError(f"K3 disagrees with the plain version at {(C, H, W)}: {err}")
            row = {"C": C, "H": H, "W": W, "card": smi}
            for name, lib in libs.items():
                row[f"{name}_ms"] = cs.time_ms(torch, lambda: call(lib), batches=5)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
