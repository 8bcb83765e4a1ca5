"""video-capture: record a replayable dataset from a camera (port of
``mvslam_tpu.apps.video_capture``).

Rebuild of ``utility/video-capture.cpp:22-126``: capture N stills at a fixed
interval and write the ``image.txt`` manifest that the visual-odometer app
replays. Exits HARDWARE_ERROR when no camera device is available (as the
reference does). Host IO only: nothing runs on a torch device, and
``--device`` is the camera's index, as in the JAX package.

Usage:
    python -m mvslam_tpu_torch.apps.video_capture OUT_DIR [--count 10]
        [--interval-ms 500] [--device 0]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from mvslam_tpu_torch.io import write_manifest
from mvslam_tpu_torch.utils.errors import ApplicationErrorCode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="video-capture", description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--count", type=int, default=10)
    ap.add_argument("--interval-ms", type=int, default=500)
    ap.add_argument("--device", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        import cv2
    except ImportError:
        print("video capture requires cv2", file=sys.stderr)
        return ApplicationErrorCode.HARDWARE_ERROR
    cap = cv2.VideoCapture(args.device)
    if not cap.isOpened():
        print(f"cannot open camera device {args.device}", file=sys.stderr)
        return ApplicationErrorCode.HARDWARE_ERROR

    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    try:
        for i in range(args.count):
            ok, frame = cap.read()
            if not ok:
                print("capture failed", file=sys.stderr)
                return ApplicationErrorCode.HARDWARE_ERROR
            path = os.path.join(args.out_dir, f"{i + 1}.jpg")
            cv2.imwrite(path, frame)
            paths.append(path)
            print(f"captured {path}", file=sys.stderr)
            time.sleep(args.interval_ms / 1000.0)
    finally:
        cap.release()

    write_manifest(os.path.join(args.out_dir, "image.txt"), paths)
    print(f"wrote {len(paths)} frames + image.txt to {args.out_dir}")
    return ApplicationErrorCode.NONE


if __name__ == "__main__":
    raise SystemExit(main())
