"""Make the checkout importable (`vobench`, the program) from any working
directory."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# the check tests step many small tensors: more threads only contend
torch.set_num_threads(2)
