"""Feature contract, the SIFT-style and SuperPoint extractors and the kNN +
Lowe matcher."""

from visualodometry_tpu_torch.frontend.interface import (  # noqa: F401
    Features,
    pad_features,
)
