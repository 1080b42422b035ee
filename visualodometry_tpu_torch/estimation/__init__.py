"""Batched RANSAC estimators: five-point essential + recoverPose, DLT PnP."""

from visualodometry_tpu_torch.estimation.essential import (  # noqa: F401
    estimate_essential_ransac,
    recover_pose,
)
from visualodometry_tpu_torch.estimation.pnp import solve_pnp_ransac  # noqa: F401
