"""Geometry core: SO(3)/SE(3), pinhole camera, batched triangulation."""

from visualodometry_tpu_torch.geometry.so3 import (  # noqa: F401
    rotation_angle,
    so3_exp,
    so3_hat,
    so3_log,
)
from visualodometry_tpu_torch.geometry.se3 import (  # noqa: F401
    make_T,
    se3_exp,
    se3_inverse,
)
from visualodometry_tpu_torch.geometry.camera import (  # noqa: F401
    pixels_to_normalized,
    project_points,
    project_points_T,
)
from visualodometry_tpu_torch.geometry.triangulation import (  # noqa: F401
    triangulate_dlt,
    triangulate_points,
)
from visualodometry_tpu_torch.geometry.linalg import (  # noqa: F401
    eigh3,
    smallest_eigvec,
    svd3,
)
