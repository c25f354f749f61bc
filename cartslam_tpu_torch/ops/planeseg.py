"""Plane segmentation from disparity derivatives (counterpart of
ops/planeseg.py: ``classify`` and ``superpixel_vote``).

Plane ids: HORIZONTAL=0, VERTICAL=1, UNKNOWN=2.  Classification tests the
horizontal range first, then the vertical range, both half-open.
"""

from __future__ import annotations

import torch

from ..kernels import tally as ktally
from .tally import table_gather

DERIVATIVE_INVALID = -32768

HORIZONTAL = 0
VERTICAL = 1
UNKNOWN = 2
PLANE_COUNT = 3


def classify(derivative: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """Derivative [H,W] int -> plane labels uint8 [H,W]; `ranges` is int32
    [2, 2]: [[h_start, h_end], [v_start, v_end]]."""
    d = derivative.to(torch.int32)
    valid = d != DERIVATIVE_INVALID
    is_h = valid & (d >= ranges[0, 0]) & (d < ranges[0, 1])
    is_v = valid & (d >= ranges[1, 0]) & (d < ranges[1, 1]) & ~is_h
    out = torch.where(is_h, HORIZONTAL, torch.where(is_v, VERTICAL, UNKNOWN))
    return out.to(torch.uint8)


def superpixel_vote(pixel_planes: torch.Tensor, labels: torch.Tensor,
                    num_labels: int) -> torch.Tensor:
    """Per-label class counts (kernel K4), winner per label (UNKNOWN, then
    VERTICAL on strictly more votes, then HORIZONTAL on strictly more than
    the running max), painted back to the pixels as uint8."""
    counts = ktally.vote_tally(
        labels.reshape(-1).to(torch.int32).contiguous(),
        pixel_planes.reshape(-1).contiguous(),
        num_labels,
        PLANE_COUNT,
    )
    best = torch.full((num_labels,), UNKNOWN, dtype=torch.int32, device=labels.device)
    best_votes = counts[:, UNKNOWN]
    take_v = counts[:, VERTICAL] > best_votes
    best = torch.where(take_v, VERTICAL, best)
    best_votes = torch.where(take_v, counts[:, VERTICAL], best_votes)
    take_h = counts[:, HORIZONTAL] > best_votes
    best = torch.where(take_h, HORIZONTAL, best)
    return table_gather(best, labels).to(torch.uint8)
