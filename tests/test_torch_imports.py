"""What the port imports: nothing of JAX, of the JAX package, or of the
optional host libraries, at import time.

In a fresh interpreter, a `sys.meta_path` finder refuses and records jax,
jaxlib, flax, optax, the JAX package `visualodometry_tpu` (not the port), PIL,
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

BLOCKED = ("jax", "jaxlib", "flax", "optax", "visualodometry_tpu", "PIL", "cv2",
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
                 "utils.video2frame", "utils.profiling", "models.optim",
                 "models.train_superpoint", "models.train_superpoint_textured",
                 "models.vo_distill", "models.train_superpoint_dense",
                 "models.train_matcher", "models.matcher_data"):
        assert f"visualodometry_tpu_torch.{name}" in imported
    assert "chip_smoke" in imported


def test_port_training_scripts_import_nothing_of_jax():
    """The port's training scripts import inside `main` (they need CUDA to
    run), so their every import statement, at any depth, is read instead:
    none names jax, flax, optax or the JAX package."""
    import ast
    import glob

    scripts = sorted(glob.glob(os.path.join(ROOT, "scripts", "train_torch_*.py")))
    assert len(scripts) == 6
    for path in scripts:
        with open(path) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                        "visualodometry_tpu")]
        assert not bad, (path, bad)
        assert "visualodometry_tpu_torch" in {n.split(".")[0] for n in names}, path
