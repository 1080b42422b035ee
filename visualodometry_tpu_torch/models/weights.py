"""The learned models' bundled weights, and the reader for their files.

The trained weights live once in the repository, beside the JAX package
that trained them (`visualodometry_tpu/models/weights/*.pkl`); the port
reads those files and keeps no copy. Each file is a pickled nested dict
of numpy arrays in the Flax layout (`{"params": {layer: {"kernel",
"bias"}}}`); `models/convert.py` turns it into a PyTorch state dict.
"""

from __future__ import annotations

import pickle
from pathlib import Path

# <repo>/visualodometry_tpu/models/weights, found from this file's place
WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "visualodometry_tpu" / "models" / "weights"

# the only globals a weight file may name: numpy's array reconstruction
_ALLOWED = {
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles nested dicts of numpy arrays and refuses anything else."""

    def find_class(self, module, name):
        if (module, name) not in _ALLOWED:
            raise pickle.UnpicklingError(
                f"weight file names {module}.{name}; only numpy arrays are allowed"
            )
        try:
            return super().find_class(module, name)
        except (ModuleNotFoundError, AttributeError) as e:
            import numpy

            raise RuntimeError(
                f"the weight files were written by numpy >= 2 and name "
                f"{module}.{name}, which numpy {numpy.__version__} does not have; "
                f"install numpy >= 2 to read them"
            ) from e


def load_flax_pickle(path: str | Path) -> dict:
    """Read a Flax-layout weight file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return _ArrayUnpickler(f).load()


def bundled(name: str) -> Path:
    """Path of a bundled weight file (which need not exist)."""
    return WEIGHTS_DIR / name
