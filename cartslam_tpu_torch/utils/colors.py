"""Flow/derivative false-color wheel (reference: src/utils/colors.cpp; the
port's copy of cartslam_tpu/utils/colors.py, numpy only).

Standard Middlebury color wheel: RY=15, YG=6, GC=4, CB=11, BM=13, MR=6,
NCOLS=55.  `compute_color(fx, fy)` returns BGR uint8, matching
cart::util::computeColor (colors.cpp:37-64).
"""

from __future__ import annotations

import numpy as np

RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
NCOLS = RY + YG + GC + CB + BM + MR


def make_color_wheel() -> np.ndarray:
    """[NCOLS, 3] int (R, G, B channel order as in the reference)."""
    wheel = np.zeros((NCOLS, 3), np.int32)
    k = 0
    for i in range(RY):
        wheel[k] = (255, 255 * i // RY, 0); k += 1
    for i in range(YG):
        wheel[k] = (255 - 255 * i // YG, 255, 0); k += 1
    for i in range(GC):
        wheel[k] = (0, 255, 255 * i // GC); k += 1
    for i in range(CB):
        wheel[k] = (0, 255 - 255 * i // CB, 255); k += 1
    for i in range(BM):
        wheel[k] = (255 * i // BM, 0, 255); k += 1
    for i in range(MR):
        wheel[k] = (255, 0, 255 - 255 * i // MR); k += 1
    return wheel


COLOR_WHEEL = make_color_wheel()


def compute_color(fx: np.ndarray, fy: np.ndarray) -> np.ndarray:
    """Vectorized flow -> BGR uint8 [..., 3] (colors.cpp:37-64)."""
    fx = np.asarray(fx, np.float32)
    fy = np.asarray(fy, np.float32)
    rad = np.sqrt(fx * fx + fy * fy)
    a = np.arctan2(-fy, -fx) / np.pi
    fk = (a + 1.0) / 2.0 * (NCOLS - 1)
    k0 = fk.astype(np.int32)
    k1 = (k0 + 1) % NCOLS
    f = fk - k0

    pix = np.zeros((*fx.shape, 3), np.uint8)
    for b in range(3):
        col0 = COLOR_WHEEL[k0, b] / 255.0
        col1 = COLOR_WHEEL[k1, b] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        pix[..., 2 - b] = (255.0 * col).astype(np.uint8)
    return pix


def index_color(idx: np.ndarray) -> np.ndarray:
    """Scalar [0,1] -> BGR via the wheel (assignColor single-arg variant)."""
    idx = np.clip(np.asarray(idx, np.float32), 0.0, 1.0)
    ix = (idx * (NCOLS - 1)).astype(np.int32)
    c = COLOR_WHEEL[ix]  # (R, G, B)
    return np.stack([c[..., 2], c[..., 1], c[..., 0]], axis=-1).astype(np.uint8)
