"""Data layer: dataset loaders, native decode and prefetch, synthetic scenes.

Importing it starts nothing: the native decoder is built at its first
call (data/native_decode.py), the prefetch thread when a loader is
iterated.
"""

from visualodometry_tpu_torch.data.loaders import (  # noqa: F401
    BaseDataset,
    KittiDataset,
    MalagaDataset,
    OwnDataset,
    ParkingDataset,
    make_dataset,
)
from visualodometry_tpu_torch.data.synthetic import SyntheticScene, make_scene  # noqa: F401
