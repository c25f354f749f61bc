"""Disparity directional derivatives + histogram (counterpart of
ops/derivative.py ``directional_derivatives``).

Central differences at offset +-2 in both directions with edge-clamped
samples, int16 wrap-around of the subtraction, and a per-channel 256-bin
histogram of valid values in [-128, 127].  The JAX package builds the
histogram from one-hot matmuls for the TPU's matrix unit; here it is a plain
integer histogram.
"""

from __future__ import annotations

import torch

from .stereo import pad_edge

DISPARITY_INVALID = -32768
DERIVATIVE_INVALID = -32768


def _clamped_shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = x.shape
    py, px = abs(dy), abs(dx)
    xp = pad_edge(x, py, px)
    return xp[py + dy : py + dy + h, px + dx : px + dx + w]


def hist256(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int32 [256] histogram of `values` in [-128, 127] where valid."""
    v = values.to(torch.int64)
    keep = valid & (v >= -128) & (v <= 127)
    return torch.bincount((v + 128)[keep], minlength=256).to(torch.int32)


def directional_derivatives(disparity: torch.Tensor):
    """int16 [H,W] -> (derivatives int16 [H,W,2], hist int32 [256,2]).

    Channel 0 = vertical, channel 1 = horizontal.
    """
    d = disparity.to(torch.int32)
    off = 2
    up = _clamped_shift(d, -off, 0)
    dn = _clamped_shift(d, off, 0)
    lf = _clamped_shift(d, 0, -off)
    rt = _clamped_shift(d, 0, off)

    vert = torch.remainder(dn - up + 32768, 65536) - 32768
    horz = torch.remainder(rt - lf + 32768, 65536) - 32768
    vert_valid = (up != DISPARITY_INVALID) & (dn != DISPARITY_INVALID)
    horz_valid = (lf != DISPARITY_INVALID) & (rt != DISPARITY_INVALID)

    out_v = torch.where(vert_valid, vert, DERIVATIVE_INVALID).to(torch.int16)
    out_h = torch.where(horz_valid, horz, DERIVATIVE_INVALID).to(torch.int16)
    hist = torch.stack([hist256(vert, vert_valid), hist256(horz, horz_valid)], dim=-1)
    return torch.stack([out_v, out_h], dim=-1), hist
