"""What the port imports: nothing of JAX, of the JAX package, or of the
optional host libraries, at import time.

In a fresh interpreter, a `sys.meta_path` finder refuses and records jax,
jaxlib, flax, the JAX package `visualodometry_tpu` (not the port), PIL,
cv2, matplotlib and rerun; the interpreter then imports every module of
`visualodometry_tpu_torch` (walked with pkgutil) and `chip_smoke`. Every
import must succeed and none of those names may have been asked for. The
machine with the card has no JAX and none of the optional viewers; the
port imports PIL and cv2 only inside the functions that use them.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, importlib.abc, json, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "visualodometry_tpu", "PIL", "cv2",
           "matplotlib", "rerun")
asked = []

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            asked.append(name)
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

import visualodometry_tpu_torch as pkg

imported = [pkg.__name__]

def fail(name):
    raise RuntimeError(f"cannot import {name}")

for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".", onerror=fail):
    importlib.import_module(info.name)
    imported.append(info.name)
importlib.import_module("chip_smoke")
imported.append("chip_smoke")
print(json.dumps({"imported": imported, "asked": asked}))
"""


def test_port_imports_nothing_of_jax_or_the_optional_libraries():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["asked"] == [], res["asked"]
    imported = set(res["imported"])
    # the modules of this slice are among those walked
    for name in ("cli", "data.loaders", "data.native_decode", "data.prefetch",
                 "viz.rerun_sink", "eval.reference_cv2", "utils.calibrate_camera",
                 "utils.video2frame", "utils.profiling"):
        assert f"visualodometry_tpu_torch.{name}" in imported
    assert "chip_smoke" in imported
