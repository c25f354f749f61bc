"""Disparity smoothing / hole filling (counterpart of ops/disparity.py).

Per iteration every pixel becomes the mean of the valid values in its
(2r-1)^2 window when more than r^2+1 of them are valid, else invalid.
Out-of-image neighbors clamp to the border pixel (value and validity).
"""

from __future__ import annotations

import torch

from .stereo import pad_edge

DISPARITY_INVALID = -32768


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over the (2r-1)x(2r-1) window centered at each pixel."""
    k = 2 * r - 1
    h, w = x.shape
    xp = pad_edge(x, r - 1, r - 1)
    rows = sum(xp[i : i + h] for i in range(k))
    return sum(rows[:, j : j + w] for j in range(k))


def interpolate(disparity: torch.Tensor, *, radius: int, iterations: int,
                min_disparity: int, max_disparity: int) -> torch.Tensor:
    """int16 x16 disparity -> smoothed int16; validity = value in
    (min_disparity, max_disparity), both exclusive."""
    min_count = radius * radius + 1
    disp = disparity
    for _ in range(iterations):
        d = disp.to(torch.int32)
        valid = (d > min_disparity) & (d < max_disparity)
        s = _box_sum(torch.where(valid, d, 0), radius)
        n = _box_sum(valid.to(torch.int32), radius)
        avg = torch.div(s, torch.clamp(n, min=1), rounding_mode="floor")
        disp = torch.where(n > min_count, avg, DISPARITY_INVALID).to(torch.int16)
    return disp
