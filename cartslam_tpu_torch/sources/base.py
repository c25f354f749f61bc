"""Data sources (reference: include/datasource.hpp, src/datasource.cpp).

A source yields per-frame dicts of host numpy arrays:
    left, right: BGR uint8 [H, W, 3]   (grayscale mode: [H, W] uint8)
plus source extras (e.g. 'zed_disparity' float32 [H, W]).

The camera intrinsics carry the OpenCV 4x4 Q reprojection matrix
(include/datasource.hpp:11-18).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraIntrinsics:
    q: np.ndarray  # 4x4 float32


def to_grayscale(frame: dict) -> dict:
    """The frame with BGR ``left``/``right`` as gray uint8 [H, W]: 0.114 B +
    0.587 G + 0.299 R in float32, rounded and clipped (the whole-pipeline
    grayscale switch, CARTSLAM_IMAGE_MAKE_GRAYSCALE of src/datasource.cpp:
    6-16, converts at the source boundary).  Other keys pass through."""
    out = dict(frame)
    for k in ("left", "right"):
        img = out.get(k)
        if img is not None and img.ndim == 3:
            y = (0.114 * img[..., 0].astype(np.float32) + 0.587 * img[..., 1]
                 + 0.299 * img[..., 2])
            out[k] = np.clip(np.round(y), 0, 255).astype(np.uint8)
    return out


class DataSource:
    def __init__(self, image_size: tuple[int, int] | None = None):
        # (height, width); None = native size.
        self.image_size = image_size
        self.intrinsics = CameraIntrinsics(q=np.eye(4, dtype=np.float32))

    # Contract mirrors reference DataSource (include/datasource.hpp:64-82).
    def is_next_ready(self) -> bool:
        raise NotImplementedError

    def is_finished(self) -> bool:
        raise NotImplementedError

    def get_next(self) -> dict | None:
        raise NotImplementedError

    def get_camera_intrinsics(self) -> CameraIntrinsics:
        return self.intrinsics

    def get_image_size(self) -> tuple[int, int]:
        if self.image_size is None:
            raise RuntimeError("image size unknown before first frame")
        return self.image_size


class DecodePrefetcher:
    """Threaded read-ahead for per-frame file decodes.

    Image decode (~15-25 ms/PNG at KITTI geometry, ~2x at 720p) releases
    the GIL under cv2, so a small pool keeps the source's sustained rate
    above the device step: `submit(key, fns)` schedules a frame's decode
    callables once, `take(key)` blocks for its results.  Sources call
    submit for the current and the next `workers // len(fns)` frames each
    get_next, so decodes overlap the device step.
    """

    def __init__(self, workers: int, name: str = "decode"):
        import concurrent.futures

        self.workers = max(2, int(workers))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix=name
        )
        self._pending: dict = {}

    def submit(self, key, fns) -> None:
        if key not in self._pending:
            self._pending[key] = [self._pool.submit(fn) for fn in fns]

    def has(self, key) -> bool:
        return key in self._pending

    def take(self, key):
        return [f.result() for f in self._pending.pop(key)]

    def clear(self) -> None:
        self._pending.clear()


def resize_bgr(img: np.ndarray, size_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize (cv2 when available, else numpy)."""
    h, w = size_hw
    if img.shape[:2] == (h, w):
        return img
    try:
        import cv2

        return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        ys = (np.arange(h) + 0.5) * img.shape[0] / h - 0.5
        xs = (np.arange(w) + 0.5) * img.shape[1] / w - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, img.shape[0] - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, img.shape[1] - 1)
        y1 = np.clip(y0 + 1, 0, img.shape[0] - 1)
        x1 = np.clip(x0 + 1, 0, img.shape[1] - 1)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        im = img.astype(np.float32)
        if im.ndim == 2:
            im = im[..., None]
        out = (
            im[y0][:, x0] * (1 - fy) * (1 - fx)
            + im[y0][:, x1] * (1 - fy) * fx
            + im[y1][:, x0] * fy * (1 - fx)
            + im[y1][:, x1] * fy * fx
        )
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
        return out[..., 0] if img.ndim == 2 else out
