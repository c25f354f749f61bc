"""Contour-relaxation superpixels (counterpart of ops/superpixels.py).

Features are per-label sufficient statistics (count, per-channel sums and
sums of squares) kept CHANNEL-MAJOR as a table [1 + 2C, L].  The table comes
from kernel K2 (``init_stats``) once per call and stays fixed; kernel K3
(``relax_sweeps``) runs the call's sweeps from it, each relabelling the
boundary pixels.

Only the production mode is ported: ``stats_refresh="frame"`` with one
phase per sweep.  Cost models (gaussian.cu:30-43, compactness.cu:28-35 of
the reference): gaussian = sum_ch [n/2 log(2 pi var) + n/2] / C with var
floored at 1/12; compactness = sum_xy [sumsq - sum^2/n].
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels import relax as krelax
from ..kernels import tally as ktally
from .tally import label_tally


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
    kind: str  # 'gaussian' | 'compactness'
    weight: float
    channels: int
    progressive: float = 0.0  # compactness only


def block_init_labels(height: int, width: int, block_w: int, block_h: int, device=None):
    """Regular-grid initialization -> (labels int32 [H, W], nBlocksX * nBlocksY)."""
    bx = -(-width // block_w)
    by = -(-height // block_h)
    ys = torch.arange(height, dtype=torch.int32, device=device)[:, None] // block_h
    xs = torch.arange(width, dtype=torch.int32, device=device)[None, :] // block_w
    return (ys * bx + xs).to(torch.int32), bx * by


def init_stats(labels: torch.Tensor, data: torch.Tensor, num_labels: int,
               psum=None) -> torch.Tensor:
    """Stat table float32 [1 + 2C, L] (count | sums | sums of squares) from
    integer-valued channel planes data [C, H, W]; negative labels drop.
    Each entry is the exact integer sum, rounded to float32 once: kernel K2
    for up to 8 channels, else the column sums of the rows [1, d, d^2]
    (kernel K7), as the JAX package routes them.  psum (spatial mode) sums
    the shards' exact int64 tables before that one rounding."""
    c = data.shape[0]
    flat = labels.reshape(-1).contiguous()
    d = data.reshape(c, -1).to(torch.int32)
    if c <= ktally.MAX_CHANNELS:
        return ktally.moment_tally(flat, d.contiguous(), num_labels, psum)
    rows = torch.cat([torch.ones_like(d[:1]), d, d * d]).T
    return label_tally(flat, rows, num_labels, psum).T.contiguous()


def relax(labels: torch.Tensor, feature_data: Sequence[torch.Tensor],
          feature_specs: Sequence[FeatureSpec], num_labels: int, iterations: int,
          direct_cost: float, diagonal_cost: float, phases: int = 1,
          stats_refresh: str = "frame", row_offset: int = 0, global_h: int | None = None,
          halo_rows: tuple[int, int] = (0, 0), psum=None) -> torch.Tensor:
    """Run `iterations` relaxation sweeps; returns the new label image.

    feature_data[i]: [H, W, C_i] aligned with the gaussian entries of
    feature_specs; compactness uses implicit (x, y) pixel coordinates.

    Height-sharded mode (parallel/spatial_flagship.py): `row_offset` is the
    global row of the first row (compactness coordinates and the
    progressive factor are global), `global_h` the full image height,
    `halo_rows` the (top, bottom) rows owned by neighbour shards, which take
    part in the sweeps but drop out of the tally, and `psum` makes the
    per-label statistics global.  Halo labels of -1 behave like the image
    edge (candidate masking).
    """
    if phases != 1 or stats_refresh != "frame":
        raise ValueError(
            f"relax(phases={phases}, stats_refresh={stats_refresh!r}) is not "
            "ported yet: only phases=1, stats_refresh='frame'"
        )
    h, w = labels.shape
    dev = labels.device
    rows = torch.arange(row_offset, row_offset + h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    coords = torch.stack([xs, rows[:, None].expand(h, w)], dim=0)

    data_list, features = [], []
    it = iter(feature_data)
    offset = 0
    prog_value = 0.0
    for spec in feature_specs:
        if spec.kind == "compactness":
            part = coords
            if spec.progressive > 0.0:
                prog_value = spec.progressive
        else:
            part = next(it)
            part = part.permute(2, 0, 1) if part.dim() == 3 else part[None]
            part = part.to(torch.float32)
        data_list.append(part)
        features.append(krelax.RelaxFeature(spec.kind, offset, part.shape[0], float(spec.weight)))
        offset += part.shape[0]
    data_all = torch.cat(data_list, dim=0).contiguous()  # [C_total, H, W]
    c_total = data_all.shape[0]

    prog = None
    if prog_value > 0.0:
        gh = torch.tensor(float(global_h or h), dtype=torch.float32, device=dev)
        prog = (1.0 + prog_value * (gh - rows) / gh).contiguous()

    top, bottom = halo_rows
    tally_labels = labels
    if top or bottom:
        core = torch.zeros(h, dtype=torch.bool, device=dev)
        core[top : h - bottom] = True
        tally_labels = torch.where(core[:, None], labels, krelax.OOB)
    stats0 = init_stats(tally_labels, data_all, num_labels, psum)
    return krelax.relax_sweeps(labels.contiguous(), stats0, data_all, features, c_total,
                               iterations, direct_cost, diagonal_cost, prog)
