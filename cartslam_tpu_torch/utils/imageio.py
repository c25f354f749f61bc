"""Image file IO helpers (BGR layout, matching cv::imread)."""

from __future__ import annotations

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
