"""ChArUco-board camera intrinsics calibration CLI.

The port's copy of visualodometry_tpu/utils/calibrate_camera.py. Same
capability as the reference utility (reference:
src/utils/calibrate_camera.py:10-277): detect a ChArUco board across a
folder of images, calibrate with distortion coefficients fixed to zero
(the VO pipeline is distortion-free pinhole), report the mean reprojection
error, and save K as a text file the `own` dataset loader can read.
Fresh implementation with argparse; OpenCV's aruco module does the board
detection (offline host tooling, not the compute path).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def calibrate_charuco(
    image_dir: Path,
    squares_x: int = 10,
    squares_y: int = 7,
    square_len: float = 0.025,
    marker_len: float = 0.018,
    dictionary: str = "DICT_4X4_100",
    min_corners: int = 8,
    verbose: bool = True,
):
    """Returns (K, mean_reprojection_error, n_used_images)."""
    import cv2

    aruco = cv2.aruco
    dict_id = getattr(aruco, dictionary)
    board = aruco.CharucoBoard(
        (squares_x, squares_y), square_len, marker_len,
        aruco.getPredefinedDictionary(dict_id),
    )
    detector = aruco.CharucoDetector(board)

    exts = {".png", ".jpg", ".jpeg", ".bmp"}
    paths = sorted(
        p for p in Path(image_dir).iterdir() if p.suffix.lower() in exts
    )
    if not paths:
        raise FileNotFoundError(f"no images in {image_dir}")

    all_obj, all_img = [], []
    size = None
    for p in paths:
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        size = (img.shape[1], img.shape[0])
        corners, ids, _, _ = detector.detectBoard(img)
        if corners is None or ids is None or len(corners) < min_corners:
            if verbose:
                print(f"  skip {p.name}: insufficient corners")
            continue
        obj, imgp = board.matchImagePoints(corners, ids)
        if obj is None or len(obj) < min_corners:
            continue
        all_obj.append(obj)
        all_img.append(imgp)
        if verbose:
            print(f"  use {p.name}: {len(corners)} corners")

    if len(all_obj) < 3:
        raise RuntimeError(
            f"only {len(all_obj)} usable calibration views (need >= 3)"
        )

    # distortion fixed to zero, like the reference (calibrate_camera.py:156-171)
    flags = (
        cv2.CALIB_ZERO_TANGENT_DIST
        | cv2.CALIB_FIX_K1
        | cv2.CALIB_FIX_K2
        | cv2.CALIB_FIX_K3
    )
    rms, K, dist, rvecs, tvecs = cv2.calibrateCamera(
        all_obj, all_img, size, None, None, flags=flags
    )

    # mean reprojection error across views
    errs = []
    for obj, imgp, r, t in zip(all_obj, all_img, rvecs, tvecs):
        proj, _ = cv2.projectPoints(obj, r, t, K, dist)
        errs.append(
            float(np.linalg.norm(proj.reshape(-1, 2) - imgp.reshape(-1, 2), axis=1).mean())
        )
    return K, float(np.mean(errs)), len(all_obj)


def generate_board_image(
    out_path,
    squares_x: int = 10,
    squares_y: int = 7,
    square_len: float = 0.025,
    marker_len: float = 0.018,
    dictionary: str = "DICT_4X4_100",
    px_per_square: int = 120,
) -> None:
    """Render the ChArUco board pattern to a printable PNG.

    The reference ships a pre-rendered pattern file
    (reference: src/utils/charuco_board_pattern.png); here it is
    generated on demand for any board geometry so the calibration CLI
    and the target it expects always agree.
    """
    import cv2
    from cv2 import aruco

    board = aruco.CharucoBoard(
        (squares_x, squares_y),
        square_len,
        marker_len,
        aruco.getPredefinedDictionary(getattr(aruco, dictionary)),
    )
    img = board.generateImage(
        (squares_x * px_per_square, squares_y * px_per_square),
        marginSize=px_per_square // 4,
    )
    cv2.imwrite(str(out_path), img)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ChArUco intrinsics calibration")
    p.add_argument("--images", type=Path)
    p.add_argument("--out", type=Path, default=Path("K.txt"))
    p.add_argument("--squares-x", type=int, default=10)
    p.add_argument("--squares-y", type=int, default=7)
    p.add_argument("--square-len", type=float, default=0.025)
    p.add_argument("--marker-len", type=float, default=0.018)
    p.add_argument("--dictionary", type=str, default="DICT_4X4_100")
    p.add_argument(
        "--make-board",
        type=Path,
        help="instead of calibrating, render the board pattern PNG here",
    )
    args = p.parse_args(argv)

    if args.make_board is not None:
        generate_board_image(
            args.make_board,
            squares_x=args.squares_x,
            squares_y=args.squares_y,
            square_len=args.square_len,
            marker_len=args.marker_len,
            dictionary=args.dictionary,
        )
        print(f"board pattern written to {args.make_board}")
        return 0
    if args.images is None:
        p.error("--images is required unless --make-board is given")

    K, err, n = calibrate_charuco(
        args.images,
        squares_x=args.squares_x,
        squares_y=args.squares_y,
        square_len=args.square_len,
        marker_len=args.marker_len,
        dictionary=args.dictionary,
    )
    print(f"calibrated from {n} views; mean reprojection error {err:.3f} px")
    print(K)
    np.savetxt(args.out, K)
    print(f"saved K to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
