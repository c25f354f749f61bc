"""KITTI odometry stereo source (reference: src/sources/kitti.cpp).

Reads image_2/image_3 PNGs (color cams 2/3), parses calib.txt P-matrices,
and builds the Q matrix exactly as the reference does (kitti.cpp:134-148):
fx/cx/cy from the LEFT camera, baseline = -P(0,3)/fx of the left camera,
Q[3,3] = (cxL - cxR) * scale / baseline.  Note the reference uses the left
camera's own P(0,3) for the baseline (the cam0->cam2 offset, not the stereo
baseline) — reproduced verbatim for output parity.
"""

from __future__ import annotations

import os

import numpy as np

from .base import DataSource, DecodePrefetcher, resize_bgr
from ..utils.imageio import imread_bgr


def _parse_calib(path: str) -> dict[int, dict]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            token, rest = line.split(":", 1)
            if not token.startswith("P"):
                continue
            cam_id = int(token[1:])
            vals = [float(v) for v in rest.split()]
            if len(vals) != 12:
                continue
            p = np.array(vals).reshape(3, 4)
            cams[cam_id] = {
                "fx": p[0, 0],
                "fy": p[1, 1],
                "cx": p[0, 2],
                "cy": p[1, 2],
                "baseline": -p[0, 3] / p[0, 0],
            }
    return cams


class KITTIDataSource(DataSource):
    LEFT_CAM = 2
    RIGHT_CAM = 3

    def __init__(
        self,
        path: str,
        sequence: int | None = None,
        image_size: tuple[int, int] | None = None,
        decode_workers: int = 6,
    ):
        super().__init__(image_size)
        # PNG decode is ~15-25 ms/image at KITTI geometry and cv2 releases
        # the GIL, so the pool size sets the source's sustained frame rate:
        # workers / (2 decodes x ~20 ms) — 2 workers cap at ~50 fps, below
        # the 81 fps device step; 6 sustain ~150 fps with headroom.
        self.decode_workers = max(2, int(decode_workers))
        path = os.path.expanduser(path)
        if sequence is not None:
            path = os.path.join(path, "sequences", f"{sequence:02d}")
        self.path = path
        self.current_frame = 0

        cams = _parse_calib(os.path.join(path, "calib.txt"))
        if self.LEFT_CAM not in cams or self.RIGHT_CAM not in cams:
            raise RuntimeError(f"calib.txt missing P{self.LEFT_CAM}/P{self.RIGHT_CAM}")
        left, right = cams[self.LEFT_CAM], cams[self.RIGHT_CAM]

        first = imread_bgr(self._img_path(self.LEFT_CAM, 0))
        native_h, native_w = first.shape[:2]
        if self.image_size is None:
            self.image_size = (native_h, native_w)
        sh = self.image_size[0] / native_h
        sw = self.image_size[1] / native_w

        q = np.eye(4, dtype=np.float32)
        q[0, 3] = -left["cx"] * sw
        q[1, 3] = -left["cy"] * sh
        q[2, 2] = 0.0
        q[2, 3] = left["fx"] * sw
        q[3, 2] = -1.0 / left["baseline"]
        q[3, 3] = (left["cx"] - right["cx"]) * sw / left["baseline"]
        self.intrinsics.q = q

    def _img_path(self, cam: int, frame: int) -> str:
        return os.path.join(self.path, f"image_{cam}", f"{frame:06d}.png")

    def is_next_ready(self) -> bool:
        return os.path.exists(self._img_path(self.LEFT_CAM, self.current_frame))

    def is_finished(self) -> bool:
        return not self.is_next_ready()

    def _prefetcher(self) -> DecodePrefetcher:
        if not hasattr(self, "_decode"):
            self._decode = DecodePrefetcher(
                self.decode_workers, name="kitti-decode"
            )
        return self._decode

    def _submit(self, frame: int):
        pf = self._prefetcher()
        if not pf.has(frame) and os.path.exists(
            self._img_path(self.LEFT_CAM, frame)
        ):
            paths = [
                self._img_path(cam, frame)
                for cam in (self.LEFT_CAM, self.RIGHT_CAM)
            ]
            pf.submit(
                frame,
                [lambda p=p: imread_bgr(p) for p in paths],
            )

    def get_next(self):
        if not self.is_next_ready():
            return None
        # Keep the pool fed workers/2 frames ahead (2 decodes per frame).
        for ahead in range(self.decode_workers // 2 + 1):
            self._submit(self.current_frame + ahead)
        left, right = self._prefetcher().take(self.current_frame)
        self.current_frame += 1
        left = resize_bgr(left, self.image_size)
        right = resize_bgr(right, self.image_size)
        return {"left": left, "right": right}

    def skip(self, n: int) -> None:
        """Seek past the first n frames (checkpoint resume)."""
        self.current_frame = n
        if hasattr(self, "_decode"):
            self._decode.clear()
