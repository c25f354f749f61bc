"""Image file IO helpers (BGR layout, matching cv::imread / cv::imwrite).

Writing takes cv2 where it is installed, else a PNG encoder on the
standard library's zlib, so PNG samples need no image package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def imread_bgr(path: str) -> np.ndarray:
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img
    except ImportError:
        from PIL import Image

        rgb = np.asarray(Image.open(path).convert("RGB"))
        return rgb[..., ::-1].copy()


def _png_bytes(img: np.ndarray) -> bytes:
    """8-bit gray [H, W] or BGR [H, W, 3] as a PNG file (RGB), every row
    with filter type 0."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3:
        img, color = np.ascontiguousarray(img[..., ::-1]), 2
    else:
        color = 0
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def imwrite_bgr(path: str, img: np.ndarray) -> None:
    """Write a BGR (or gray) uint8 image; PNG without cv2."""
    try:
        import cv2
    except ImportError:
        if not path.lower().endswith(".png"):
            raise ValueError(f"{path}: without cv2 only PNG is written") from None
        with open(path, "wb") as f:
            f.write(_png_bytes(img))
        return
    if not cv2.imwrite(path, img):
        raise OSError(f"cv2 could not write {path}")
