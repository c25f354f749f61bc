"""Contour-relaxation superpixels (counterpart of ops/superpixels.py).

Features are per-label sufficient statistics (count, per-channel sums and
sums of squares) kept CHANNEL-MAJOR as a table [1 + 2C, L], from kernel K2
(``init_stats``; K7 above 8 channels).  A sweep is ``phases`` checkerboard
sub-steps, each relabelling the boundary pixels of one parity on global
rows (kernel K3).  ``stats_refresh="frame"`` tallies the table once per call
and runs all sub-steps from it (``relax_sweeps``); ``"phase"``, the
reference's incremental semantics, re-tallies it after every sub-step and
runs each sub-step from the fresh table (``relax_phase``).  Cost models
(gaussian.cu:30-43, compactness.cu:28-35 of the reference): gaussian =
sum_ch [n/2 log(2 pi var) + n/2] / C with var floored at 1/12; compactness
= sum_xy [sumsq - sum^2/n].
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..kernels import relax as krelax
from ..kernels import tally as ktally


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
    integer-valued channel planes data [C, H, W] (float, or already int32:
    then used as they are); negative labels drop.  Each entry is the exact
    integer sum, rounded to float32 once: kernel K2 for up to 8 channels, on
    the image's layout, else the per-label sums of the rows [1, d, d^2]
    [1 + 2C, H, W] on the same layout (kernel K7), as the JAX package routes
    them.  psum (spatial mode) sums the shards' exact int64 tables before
    that one rounding."""
    c = data.shape[0]
    d = data.to(torch.int32)
    if c <= ktally.MAX_CHANNELS:
        return ktally.moment_tally(labels.contiguous(), d.contiguous(), num_labels, psum)
    rows = torch.cat([torch.ones_like(d[:1]), d, d * d])
    return ktally.label_tally(labels.contiguous(), rows, num_labels, psum)


def relax(labels: torch.Tensor, feature_data: Sequence[torch.Tensor],
          feature_specs: Sequence[FeatureSpec], num_labels: int, iterations: int,
          direct_cost: float, diagonal_cost: float, phases: int = 1,
          stats_refresh: str = "frame", row_offset: int = 0, global_h: int | None = None,
          halo_rows: tuple[int, int] = (0, 0), psum=None) -> torch.Tensor:
    """Run `iterations` relaxation sweeps; returns the new label image.

    feature_data[i]: [H, W, C_i] aligned with the gaussian entries of
    feature_specs; compactness uses implicit (x, y) pixel coordinates.

    phases: checkerboard sub-steps per sweep (1: every boundary pixel at
    once; 2: race-free alternating updates).  stats_refresh: 'frame' keeps
    the call's first table; 'phase' re-tallies it after every sub-step (the
    last sub-step's re-tally would feed nothing and is skipped).

    Height-sharded mode (parallel/spatial_flagship.py): `row_offset` is the
    global row of the first row (compactness coordinates, the progressive
    factor and the checkerboard parity are global), `global_h` the full
    image height, `halo_rows` the (top, bottom) rows owned by neighbour
    shards, which take part in the sweeps but drop out of every tally, and
    `psum` makes the per-label statistics global.  Halo labels of -1 behave
    like the image edge (candidate masking).
    """
    if stats_refresh not in ("frame", "phase"):
        raise ValueError(f"unknown stats_refresh {stats_refresh!r}; expected 'frame' or 'phase'")
    if phases < 1:
        raise ValueError(f"relax phases must be >= 1, got {phases}")
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
        # The height as a float32 scalar made on the device by a fill (no
        # host copy): divided by a Python float, CUDA would multiply by the
        # reciprocal and round otherwise than the CPU and the kernel.
        gh = torch.full((), float(global_h or h), dtype=torch.float32, device=dev)
        prog = (1.0 + prog_value * (gh - rows) / gh).contiguous()

    top, bottom = halo_rows
    core = None
    if top or bottom:
        core = torch.zeros(h, dtype=torch.bool, device=dev)
        core[top : h - bottom] = True

    # The int32 planes K2 tallies, converted once for all of the call's
    # tallies ('phase' stats re-tally after every sub-step).
    planes = data_all.to(torch.int32)

    def tally(lab):
        return init_stats(lab if core is None else torch.where(core[:, None], lab, krelax.OOB),
                          planes, num_labels, psum)

    labels = labels.contiguous()
    stats = tally(labels)
    if stats_refresh == "frame":
        return krelax.relax_sweeps(labels, stats, data_all, features, c_total, iterations,
                                   direct_cost, diagonal_cost, prog, phases=phases,
                                   row0=row_offset)
    steps = iterations * phases
    for k in range(steps):
        labels = krelax.relax_phase(labels, stats, data_all, features, c_total, k % phases,
                                    phases, direct_cost, diagonal_cost, prog, row0=row_offset)
        if k + 1 < steps:
            stats = tally(labels)
    return labels


def boundary_mask(labels: torch.Tensor) -> torch.Tensor:
    """The 8-neighbourhood label-boundary mask (the reference's
    computeBoundaries): bool [H, W], true where a neighbour inside the frame
    has another label; neighbours beyond the frame are ignored."""
    h, w = labels.shape
    padded = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=krelax.OOB)
    out = torch.zeros((h, w), dtype=torch.bool, device=labels.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb = padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
                out |= (nb != krelax.OOB) & (nb != labels)
    return out
