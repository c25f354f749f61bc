"""Kernel K3: the contour-relaxation sweeps of one ``relax`` call
(csrc/relax.cu), and its plain version.

Replaces the Pallas ``relax_phase_pallas`` (cartslam_tpu/ops/pallas/
relax.py:240) in 'frame' stats mode with one phase per sweep.
``relax_sweeps`` runs a call's sweeps from the fixed per-label table.  Its
plain version ``relax_sweeps_plain`` gathers the table into the per-pixel
stat image and runs ``relax_sweep_plain`` once per sweep: the port of
``phase_update`` (cartslam_tpu/ops/superpixels.py:335-417) followed by the
carried stat-image update (:515).  On a CUDA tensor the wrapper launches the
kernels or raises; on a CPU tensor it runs the plain version.

Every float operation of the plain version is a separate PyTorch op, in the
JAX code's order; divisions by a constant divide by a tensor, because CUDA
PyTorch turns division by a Python scalar into a multiplication by its
reciprocal.  The kernel follows the same order and is built without FMA
contraction.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import torch

from ..ops.tally import table_gather
from . import build

# Counts launches of the fused sweep kernel (each runs up to
# SWEEPS_PER_LAUNCH sweeps; the per-call label-row prologue rides with them).
COUNTER = build.counter("relax")
OOB = -1
# Candidate order = the reference's insertion order (x outer, y inner).
OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
DIRECT = {(-1, 0), (1, 0), (0, -1), (0, 1)}
KINDS = {"gaussian": 0, "compactness": 1}
MAX_FEATURES = 4
MAX_CHANNELS = 8
# Floats per label in the kernel's label-major row table: 1 + 2C stats, then
# one cost per feature.
ROW_STRIDE = 32
# Sweeps per launch of the fused kernel (temporal blocking: each launch
# recomputes a halo as deep as its sweeps).  Chosen from chip_smoke.py's
# timings of 1-24 sweeps a launch on the flagship's 8- and 24-sweep calls
# (PERF.md).
SWEEPS_PER_LAUNCH = 2


@dataclasses.dataclass(frozen=True)
class RelaxFeature:
    kind: str  # 'gaussian' | 'compactness'
    offset: int  # first channel in the packed [C_total] layout
    channels: int
    weight: float


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = in[y + dy, x + dx] with constant fill out of bounds."""
    h, w = x.shape[-2:]
    py, px = abs(dy), abs(dx)
    xp = torch.nn.functional.pad(x, (px, px, py, py), value=fill)
    return xp[..., py + dy : py + dy + h, px + dx : px + dx + w]


def _shift_edge(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift [R, H, W] spatially with edge-clamped samples."""
    h, w = x.shape[-2:]
    rows = (torch.arange(h, device=x.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device) + dx).clamp(0, w - 1)
    return x[:, rows][:, :, cols]


def feature_costs(img: torch.Tensor, features: Sequence[RelaxFeature],
                  c_total: int) -> list[torch.Tensor]:
    """Per-feature cost planes from a stacked stat image [1 + 2C, ...]."""
    dev = img.device
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)
    var_floor = torch.tensor(1.0 / 12.0, dtype=torch.float32, device=dev)
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=dev)
    n = img[0]
    n_safe = torch.maximum(n, one)
    out = []
    for f in features:
        acc = None
        for c in range(f.channels):
            s = img[1 + f.offset + c]
            ss = img[1 + c_total + f.offset + c]
            if f.kind == "gaussian":
                q = s / n_safe
                var = torch.maximum(ss / n_safe - q * q, var_floor)
                half = n / 2.0
                t = half * torch.log(two_pi * var) + half
            else:
                t = ss - (s * s) / n_safe
            acc = t if acc is None else acc + t
        if f.kind == "gaussian":
            acc = acc / torch.tensor(float(f.channels), dtype=torch.float32, device=dev)
        out.append(torch.where(n > 0, acc, 0.0))
    return out


def relax_sweep_plain(labels, stat_img, pixel_rows, features, c_total,
                      direct_cost, diagonal_cost, prog=None):
    """One synchronous sweep -> (new labels, new stat image)."""
    h, w = labels.shape
    nbs = [_shift(labels, dy, dx, OOB) for (dx, dy) in OFFSETS]
    boundary = torch.zeros((h, w), dtype=torch.bool, device=labels.device)
    for (dx, dy), nb in zip(OFFSETS, nbs):
        if (dx, dy) != (0, 0):
            boundary = boundary | ((nb != OOB) & (nb != labels))
    active = boundary & (labels != OOB)

    cost_img = feature_costs(stat_img, features, c_total)
    old_minus = feature_costs(stat_img - pixel_rows, features, c_total)
    best_cost = torch.full((h, w), math.inf, dtype=torch.float32, device=labels.device)
    best_label = labels
    upd = stat_img
    for (dx, dy), cand in zip(OFFSETS, nbs):
        cand_valid = cand != OOB
        cand_c = torch.where(cand_valid, cand, 0)
        cand_img = _shift_edge(stat_img, dy, dx)
        cand_cost = [_shift(ci, dy, dx, 0.0) for ci in cost_img]

        clique = torch.zeros((h, w), dtype=torch.float32, device=labels.device)
        for (dx2, dy2), nb2 in zip(OFFSETS, nbs):
            if (dx2, dy2) == (0, 0):
                continue
            cc = direct_cost if (dx2, dy2) in DIRECT else diagonal_cost
            clique = clique + torch.where((nb2 != OOB) & (nb2 != cand_c), cc, 0.0)

        cand_plus = feature_costs(cand_img + pixel_rows, features, c_total)
        total = clique
        is_old = cand_c == labels
        for i, f in enumerate(features):
            delta = old_minus[i] + cand_plus[i] - cost_img[i] - cand_cost[i]
            if f.kind == "compactness" and prog is not None:
                delta = delta * prog[:, None]
            total = total + f.weight * torch.where(is_old, 0.0, delta)
        total = torch.where(cand_valid, total, math.inf)
        take = total < best_cost
        best_cost = torch.where(take, total, best_cost)
        best_label = torch.where(take, cand_c, best_label)
        upd = torch.where(take[None], cand_img, upd)

    new_labels = torch.where(active, best_label, labels)
    return new_labels, torch.where(active[None], upd, stat_img)


def launches(iterations: int) -> int:
    """Launches of the fused kernel for one call of `iterations` sweeps."""
    return -(-iterations // SWEEPS_PER_LAUNCH)


def relax_sweeps_plain(labels, table, data, features, c_total, iterations, direct_cost,
                       diagonal_cost, prog=None, return_stats=False):
    """`iterations` sweeps from the fixed table: the table gathered into the
    stat image, then relax_sweep_plain once per sweep.  Returns the labels,
    and with return_stats also the carried stat image."""
    stat_img = table_gather(table, labels).contiguous()
    pixel_rows = torch.cat([torch.ones_like(data[:1]), data, data * data]).contiguous()
    for _ in range(iterations):
        labels, stat_img = relax_sweep_plain(labels, stat_img, pixel_rows, features, c_total,
                                             direct_cost, diagonal_cost, prog)
    return (labels, stat_img) if return_stats else labels


def relax_sweeps(labels, table, data, features: Sequence[RelaxFeature], c_total: int,
                 iterations: int, direct_cost: float, diagonal_cost: float, prog=None, *,
                 return_stats: bool = False):
    """`iterations` relaxation sweeps in 'frame' stats mode -> new labels.

    labels int32 [H, W] (-1: outside the frame, never relabelled); table
    float32 [1 + 2C, L] (count | sums | sums of squares per label, K2 or
    K7); data float32 [C, H, W], the feature channels in the layout of
    `features`; prog: float32 [H] progressive-compactness factor or None.
    With return_stats, also table_gather(table, labels) of the new labels:
    the stat image relax_phase_pallas carries (on the CPU, the plain
    version's carried image, equal to it)."""
    if labels.device.type == "cpu":
        COUNTER.plain_calls += 1
        return relax_sweeps_plain(labels, table, data, features, c_total, iterations,
                                  direct_cost, diagonal_cost, prog, return_stats)
    h, w = labels.shape
    nstat = 1 + 2 * c_total
    if len(features) > MAX_FEATURES or c_total > MAX_CHANNELS:
        raise ValueError(f"relax kernel takes <= {MAX_FEATURES} features and "
                         f"<= {MAX_CHANNELS} channels")
    build.expect(labels, "labels", torch.int32, (h, w))
    build.expect(table, "table", torch.float32, (nstat, table.shape[-1]), labels.device)
    build.expect(data, "data", torch.float32, (c_total, h, w), labels.device)
    if prog is not None:
        build.expect(prog, "prog", torch.float32, (h,), labels.device)
    cur = labels
    if iterations > 0:
        lib = build.library()
        s = build.stream()
        nf, num = len(features), table.shape[-1]
        feats = ((ctypes.c_int * nf)(*[KINDS[f.kind] for f in features]),
                 (ctypes.c_int * nf)(*[f.offset for f in features]),
                 (ctypes.c_int * nf)(*[f.channels for f in features]),
                 (ctypes.c_float * nf)(*[f.weight for f in features]))
        rows = torch.empty((num + 1, ROW_STRIDE), dtype=torch.float32, device=labels.device)
        build.check(lib.relax_label_rows(table.data_ptr(), rows.data_ptr(), num, c_total, nf,
                                         *feats, s), "relax_label_rows")
        bufs = (torch.empty_like(labels), torch.empty_like(labels))
        done = 0
        while done < iterations:
            n = min(SWEEPS_PER_LAUNCH, iterations - done)
            out = bufs[1] if cur is bufs[0] else bufs[0]
            build.check(lib.relax_sweeps(cur.data_ptr(), data.data_ptr(), rows.data_ptr(),
                                         out.data_ptr(), h, w, num, c_total, nf, *feats,
                                         build.ptr(prog), direct_cost, diagonal_cost, n, s),
                        "relax_sweeps")
            COUNTER.launches += 1
            cur, done = out, done + n
    return (cur, table_gather(table, cur)) if return_stats else cur
