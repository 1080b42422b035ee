"""Sliding-window bundle adjustment: damped Gauss-Newton with Schur
elimination (`solver.py`), window assembly from keyframes (`window.py`),
the chunk runner's windowed BA (`inloop.py`) and loop-free pose-graph
smoothing (`pose_graph.py`). Port of visualodometry_tpu/ba/; no kernel of
its own (the JAX package has no Pallas kernel here)."""

from visualodometry_tpu_torch.ba.solver import BAProblem, ba_cost, ba_solve  # noqa: F401
from visualodometry_tpu_torch.ba.window import assemble_window, write_back  # noqa: F401
