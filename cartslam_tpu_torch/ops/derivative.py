"""Disparity derivatives + histograms (counterpart of ops/derivative.py).

``directional_derivatives`` (the derivative module): central differences at
offset +-2 in both directions with edge-clamped samples, int16 wrap-around
of the subtraction, and a per-channel 256-bin histogram of valid values in
[-128, 127].  ``planeseg_derivative`` (the pixel plane-segmentation
module's own): a vertical 5-tap valid mean, then a +-1 vertical difference
and its histogram.  The JAX package builds the histograms from one-hot
matmuls for the TPU's matrix unit; here they are plain integer histograms.
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
    """int32 [256] histogram of `values` in [-128, 127] where valid.  One
    ``torch.histc`` over [-128, 128] with every other value moved out of
    range: bin v + 128 exactly, float32 counts exact below 2^24.  (A
    bincount of the masked values would read their count back to the
    host, which a captured step cannot do.)"""
    keep = valid & (values >= -128) & (values <= 127)
    v = torch.where(keep, values, -1024).to(torch.float32)
    return torch.histc(v, bins=256, min=-128, max=128).to(torch.int32)


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


def planeseg_smooth(disparity: torch.Tensor) -> torch.Tensor:
    """int32 [H,W]: each pixel the floor mean of the valid samples of its
    vertical window [-2, +2] (edge-clamped), DISPARITY_INVALID where none is
    valid: the low-pass of calculateDerivatives (planeseg.cu:31-142)."""
    d = disparity.to(torch.int32)
    taps = [_clamped_shift(d, k, 0) for k in (-2, -1, 0, 1, 2)]
    valid = [t != DISPARITY_INVALID for t in taps]
    s = sum(torch.where(v, t, 0) for t, v in zip(taps, valid))
    n = sum(v.to(torch.int32) for v in valid)
    return torch.where(n > 0, torch.div(s, n.clamp(min=1), rounding_mode="floor"),
                       DISPARITY_INVALID)


def planeseg_diff(smoothed: torch.Tensor):
    """(raw derivative int32, valid bool) [H,W] of a smoothed image:
    smoothed[y+1] - smoothed[y-1] (edge-clamped), valid where the centre and
    both neighbours are."""
    up = _clamped_shift(smoothed, -1, 0)
    dn = _clamped_shift(smoothed, 1, 0)
    ok = (smoothed != DISPARITY_INVALID) & (up != DISPARITY_INVALID) & (dn != DISPARITY_INVALID)
    return dn - up, ok


def planeseg_derivative(disparity: torch.Tensor):
    """int16 [H,W] -> (derivative int16 [H,W], hist int32 [256]): the pixel
    plane segmentation's low-pass vertical derivative (planeseg_smooth, then
    planeseg_diff; int16 wrap-around) and the histogram of its valid raw
    values."""
    deriv, ok = planeseg_diff(planeseg_smooth(disparity))
    return torch.where(ok, deriv, DERIVATIVE_INVALID).to(torch.int16), hist256(deriv, ok)
