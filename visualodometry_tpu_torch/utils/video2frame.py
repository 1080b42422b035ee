"""Video -> frame-dump utility for the `own` dataset.

The port's copy of visualodometry_tpu/utils/video2frame.py. Same
capability as the reference utility (reference: src/utils/video2frame.py:
6-61): find the first video file under the
dataset directory and dump every frame as `img_%05d.jpg` into `images/`.
Uses imageio (ffmpeg) with an OpenCV fallback.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

VIDEO_EXTS = (".mov", ".mp4", ".avi", ".mkv")


def find_video(directory: Path) -> Path | None:
    for ext in VIDEO_EXTS:
        hits = sorted(directory.glob(f"*{ext}")) + sorted(
            directory.glob(f"*{ext.upper()}")
        )
        if hits:
            return hits[0]
    return None


def video_to_frames(video: Path, out_dir: Path, stride: int = 1) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    try:
        import imageio.v3 as iio

        for i, frame in enumerate(iio.imiter(video)):
            if i % stride:
                continue
            iio.imwrite(out_dir / f"img_{count:05d}.jpg", frame)
            count += 1
    except Exception:
        import cv2

        cap = cv2.VideoCapture(str(video))
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i % stride == 0:
                cv2.imwrite(str(out_dir / f"img_{count:05d}.jpg"), frame)
                count += 1
            i += 1
        cap.release()
    return count


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="dump video frames for own dataset")
    p.add_argument("--dir", type=Path, default=Path("data/my_dataset"))
    p.add_argument("--stride", type=int, default=1)
    args = p.parse_args(argv)

    video = find_video(args.dir)
    if video is None:
        print(f"no video found in {args.dir}", file=sys.stderr)
        return 1
    n = video_to_frames(video, args.dir / "images", stride=args.stride)
    print(f"wrote {n} frames from {video.name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
