"""Dataset loaders: path lists, intrinsics, ground-truth poses.

The port's own copy of visualodometry_tpu/data/loaders.py, the on-disk
contract of the reference loaders (reference:
src/modules/dataset_loader.py:10-195): KITTI (hardcoded K, poses columns
[3, 11], image_0/*.png), Malaga (hardcoded K, no GT, *_left.jpg), Parking
(comma-separated K.txt, poses [3, 11], images/*.png), Own (my_dataset/,
*.jpg). Image decoding is NOT done here: data/native_decode.py and
data/prefetch.py own it.
"""

from __future__ import annotations

import io
from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np

KITTI_K = np.array(
    [[7.18856e02, 0.0, 6.071928e02], [0.0, 7.18856e02, 1.852157e02], [0.0, 0.0, 1.0]]
)
MALAGA_K = np.array(
    [[621.18428, 0.0, 404.0076], [0.0, 621.18428, 309.05989], [0.0, 0.0, 1.0]]
)


def _load_csv_matrix(path: Path) -> np.ndarray:
    """Parse a whitespace/comma mixed 3x3 matrix file (Parking/Own K.txt)."""
    text = path.read_text().replace(",", " ").strip()
    return np.loadtxt(io.StringIO(text), dtype=np.float64)


def _load_xz_ground_truth(path: Path) -> np.ndarray | None:
    """Poses file -> (F, 2) array of (x, z) translations (columns 3, 11)."""
    if not path.exists():
        return None
    poses = np.atleast_2d(np.loadtxt(path))
    return poses[:, [3, 11]]


class BaseDataset(ABC):
    """Path/intrinsics/GT resolution for one sequence."""

    def __init__(self, base_path: Path | str) -> None:
        self.base_path = Path(base_path)
        self.K: np.ndarray | None = None
        self.ground_truth: np.ndarray | None = None
        self.image_files: list[Path] = []
        self.load()

    @abstractmethod
    def load(self) -> None: ...

    def __len__(self) -> int:
        return len(self.image_files)


class KittiDataset(BaseDataset):
    def __init__(self, base_path: Path | str, sequence: str = "05") -> None:
        self.sequence = sequence
        super().__init__(base_path)

    def load(self) -> None:
        root = self.base_path / "kitti"
        self.K = KITTI_K.copy()
        self.ground_truth = _load_xz_ground_truth(
            root / "poses" / f"{self.sequence}.txt"
        )
        self.image_files = sorted((root / self.sequence / "image_0").glob("*.png"))


class MalagaDataset(BaseDataset):
    def load(self) -> None:
        img_dir = (
            self.base_path
            / "malaga"
            / "malaga-urban-dataset-extract-07_rectified_800x600_Images"
        )
        self.K = MALAGA_K.copy()
        self.ground_truth = None
        self.image_files = sorted(img_dir.glob("*_left.jpg"))


class ParkingDataset(BaseDataset):
    def load(self) -> None:
        root = self.base_path / "parking"
        self.K = _load_csv_matrix(root / "K.txt")
        self.ground_truth = _load_xz_ground_truth(root / "poses.txt")
        self.image_files = sorted((root / "images").glob("*.png"))


class OwnDataset(BaseDataset):
    def load(self) -> None:
        root = self.base_path / "my_dataset"
        self.K = _load_csv_matrix(root / "K.txt")
        self.ground_truth = _load_xz_ground_truth(root / "poses.txt")
        self.image_files = sorted((root / "images").glob("*.jpg"))


def make_dataset(
    name: str, base_path: Path | str, sequence: str = "05"
) -> BaseDataset:
    """Factory matching the reference CLI's dataset switch
    (reference: src/main.py:38-45)."""
    if name == "kitti":
        return KittiDataset(base_path, sequence=sequence)
    if name == "malaga":
        return MalagaDataset(base_path)
    if name == "parking":
        return ParkingDataset(base_path)
    if name == "own":
        return OwnDataset(base_path)
    raise ValueError(f"unknown dataset '{name}'")
