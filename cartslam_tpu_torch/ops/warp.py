"""Bounded backward warps (counterpart of cartslam_tpu/ops/warp.py).

The JAX package writes a bounded single-axis per-pixel gather as a select
over the 2r+1 statically shifted copies of the image, because a per-index
gather is the TPU's most expensive op class.  The select is exact, so on the
GPU the same function is one gather with the same validity mask.

The 2-D warp is approximated separably, columns first with the output
pixel's flow, then rows:

    out[y, x] ~ img[y - fy[y, x], x - fx[y - fy, x]]

i.e. the horizontal flow is sampled at the source row.  That is the
temporal vote's ``warp_mode='select'``.
"""

from __future__ import annotations

import torch


def select_gather_axis(img: torch.Tensor, f: torch.Tensor, r: int, axis: int,
                       fill) -> torch.Tensor:
    """Exact per-pixel single-axis gather: out[p] = img[p - f[p] * e_axis].

    f int32 of img's shape; displacements outside [-r, r] and sources
    outside the image give `fill`.
    """
    size = img.shape[axis]
    shape = [1] * img.dim()
    shape[axis] = size
    pos = torch.arange(size, dtype=f.dtype, device=f.device).view(shape)
    src = pos - f
    valid = (src >= 0) & (src < size) & (f >= -r) & (f <= r)
    out = torch.gather(img, axis, src.clamp(0, size - 1).to(torch.int64))
    return torch.where(valid, out, torch.full_like(img, fill))


def separable_warp(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor, ry: int, rx: int,
                   fill) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward 2-D warp img[y - fy, x - fx] by two exact one-axis passes.

    The column pass uses fx at the source row (see the module docstring).
    Returns (warped, valid), where valid marks in-image, in-range
    displacements.
    """
    h, w = img.shape[:2]
    ys = torch.arange(h, dtype=fy.dtype, device=fy.device)[:, None]
    xs = torch.arange(w, dtype=fx.dtype, device=fx.device)[None, :]
    valid = (((ys - fy) >= 0) & ((ys - fy) < h) & ((xs - fx) >= 0) & ((xs - fx) < w)
             & (fy >= -ry) & (fy <= ry) & (fx >= -rx) & (fx <= rx))
    csel = select_gather_axis(img, fx, rx, axis=1, fill=fill)
    out = select_gather_axis(csel, fy, ry, axis=0, fill=fill)
    return torch.where(valid, out, torch.full_like(out, fill)), valid
