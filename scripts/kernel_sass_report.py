#!/usr/bin/env python3
"""Registers, spills and the instruction mix of each kernel a source builds.

    python3 scripts/kernel_sass_report.py [blur_stack|match_top2|patches]

Needs nvcc and cuobjdump (the CUDA toolkit). Builds
`visualodometry_tpu_torch/csrc/<name>.cu` with the port's nvcc flags plus
`-Xptxas -v` into a temporary directory, then prints one JSON line per
kernel (template instantiation): registers, spill bytes and stack frame as
ptxas reports them, and counts from the SASS that `cuobjdump -sass` shows:
FFMA (and how many of them take an operand from the constant bank or a
uniform register), LDS (shared loads, by width), LDC / ULDC (constant-bank
loads), LDGSTS (cp.async), STG and local-memory traffic (LDL / STL).
Instructions predicated `@!PT`, which never execute, are not counted.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from visualodometry_tpu_torch.ops import _build  # noqa: E402

# one instruction: its predicate, opcode and operands
OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def ptxas_info(log: str) -> dict:
    """Per mangled kernel name: registers, spill bytes and stack frame."""
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            info[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[name]["registers"] = int(m.group(1))
    return info


def sass_counts(sass: str) -> dict:
    """Per mangled kernel name: counts of the instructions that matter here."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        # `@!PT` never executes: the fillers the compiler puts after cp.async
        ops = [(op, args) for pred, op, args in OPCODE.findall(block)
               if pred.strip() != "@!PT"]
        c = Counter(op for op, _ in ops)
        ffma = [args for op, args in ops if op.startswith("FFMA")]
        out[name] = {
            "instructions": len(ops),
            "FFMA": len(ffma),
            "FFMA_const_or_uniform_operand": sum(1 for a in ffma if re.search(r"c\[|\bUR\d", a)),
            "LDS": {op: n for op, n in c.items() if op.startswith("LDS")},
            "LDC": sum(n for op, n in c.items() if op.startswith("LDC")),
            "ULDC": sum(n for op, n in c.items() if op.startswith("ULDC")),
            "LDGSTS": sum(n for op, n in c.items() if op.startswith("LDGSTS")),
            "STG": sum(n for op, n in c.items() if op.startswith("STG")),
            "LDL_STL": sum(n for op, n in c.items() if op.startswith(("LDL", "STL"))),
        }
    return out


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else "blur_stack"
    if name not in _build.KERNEL_SOURCES:
        raise SystemExit(f"unknown kernel source {name!r}; one of {_build.KERNEL_SOURCES}")
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, f"{name}.so")
        build = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", so, str(_build.CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if build.returncode:
            print(build.stdout + build.stderr, file=sys.stderr)
            return 1
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                              check=True).stdout
    regs = ptxas_info(build.stdout + build.stderr)
    counts = sass_counts(sass)
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    names = list(counts)
    if os.path.exists(filt):  # readable template arguments
        names = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    for kernel, readable in zip(counts, names):
        print(json.dumps({"kernel": readable.replace("(anonymous namespace)::", ""),
                          **regs.get(kernel, {}), **counts[kernel]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
