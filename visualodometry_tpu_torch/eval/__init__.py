"""Trajectory evaluation (ATE / RPE), numpy on the host."""

from visualodometry_tpu_torch.eval.ate import (  # noqa: F401
    ate_rmse,
    rpe_rmse,
    umeyama_alignment,
)
