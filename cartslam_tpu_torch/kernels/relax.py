"""Kernel K3: the contour-relaxation sub-steps of a ``relax`` call
(csrc/relax.cu), and its plain versions.

Replaces the Pallas ``relax_phase_pallas`` (cartslam_tpu/ops/pallas/
relax.py:240).  A sweep is ``phases`` sub-steps; sub-step ``p`` relabels the
boundary pixels whose checkerboard parity ``(row0 + y + x) mod phases`` is
``p``, on global rows (``row0`` is the global row of row 0).
``relax_sweeps`` runs a 'frame'-mode call's sweeps from the fixed per-label
table; ``relax_phase`` runs one sub-step from a table ('phase' stats mode,
which re-tallies the table after every sub-step).  Their plain versions
gather the table into the per-pixel stat image and run
``relax_sweep_plain`` once per sub-step: the port of ``phase_update``
(cartslam_tpu/ops/superpixels.py:335-417) followed by the carried
stat-image update (:515).  On a CUDA tensor the wrappers launch the kernels
or raise; on a CPU tensor they run the plain versions.

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
# SWEEPS_PER_LAUNCH sweeps, or one 'phase'-mode sub-step; the label-row
# prologue of each table rides with them).
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
# Sweeps per launch of the fused kernel in 'frame' stats mode (temporal
# blocking: each launch recomputes a halo as deep as its sub-steps, the
# sweeps times the phases).  Chosen from chip_smoke.py's timings of 1-24
# sweeps a launch on the flagship's 8- and 24-sweep calls, and of 1-12 with
# two phases (PERF.md).
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


def phase_mask(h: int, w: int, phase: int, num_phases: int, row0: int, device) -> torch.Tensor:
    """bool [h, w]: the pixels of checkerboard parity `phase`, on global rows
    (row0 is the global row of row 0, negative for a shard whose halo starts
    above the frame; the remainder is a floor remainder, as jnp's %)."""
    ys = torch.arange(h, dtype=torch.int64, device=device)[:, None] + row0
    xs = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    return torch.remainder(ys + xs, num_phases) == phase


def relax_sweep_plain(labels, stat_img, pixel_rows, features, c_total,
                      direct_cost, diagonal_cost, prog=None, phase=0, num_phases=1, row0=0):
    """One synchronous sub-step (a whole sweep with one phase) -> (new
    labels, new stat image).  Only boundary pixels of parity `phase` move."""
    h, w = labels.shape
    nbs = [_shift(labels, dy, dx, OOB) for (dx, dy) in OFFSETS]
    boundary = torch.zeros((h, w), dtype=torch.bool, device=labels.device)
    for (dx, dy), nb in zip(OFFSETS, nbs):
        if (dx, dy) != (0, 0):
            boundary = boundary | ((nb != OOB) & (nb != labels))
    active = boundary & (labels != OOB)
    if num_phases > 1:
        active = active & phase_mask(h, w, phase, num_phases, row0, labels.device)

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


def launches(iterations: int, phases: int = 1, stats_refresh: str = "frame") -> int:
    """Launches of the fused kernel for one relax call of `iterations`
    sweeps of `phases` sub-steps: launches of up to SWEEPS_PER_LAUNCH
    sweeps in 'frame' stats mode, one a sub-step in 'phase' mode."""
    if stats_refresh == "phase":
        return iterations * phases
    return -(-iterations // SWEEPS_PER_LAUNCH)


def _pixel_rows(data: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.ones_like(data[:1]), data, data * data]).contiguous()


def relax_sweeps_plain(labels, table, data, features, c_total, iterations, direct_cost,
                       diagonal_cost, prog=None, return_stats=False, phases=1, row0=0):
    """`iterations` sweeps of `phases` sub-steps from the fixed table: the
    table gathered into the stat image, then relax_sweep_plain once per
    sub-step.  Returns the labels, and with return_stats also the carried
    stat image."""
    stat_img = table_gather(table, labels).contiguous()
    pixel_rows = _pixel_rows(data)
    for _ in range(iterations):
        for phase in range(phases):
            labels, stat_img = relax_sweep_plain(labels, stat_img, pixel_rows, features,
                                                 c_total, direct_cost, diagonal_cost, prog,
                                                 phase, phases, row0)
    return (labels, stat_img) if return_stats else labels


def relax_phase_plain(labels, table, data, features, c_total, phase, phases, direct_cost,
                      diagonal_cost, prog=None, row0=0):
    """One sub-step of parity `phase` from the table -> new labels."""
    return relax_sweep_plain(labels, table_gather(table, labels).contiguous(),
                             _pixel_rows(data), features, c_total, direct_cost, diagonal_cost,
                             prog, phase, phases, row0)[0]


def c_features(features: Sequence[RelaxFeature]):
    """The C entry points' feature arrays: kinds, offsets, channels, weights."""
    nf = len(features)
    return ((ctypes.c_int * nf)(*[KINDS[f.kind] for f in features]),
            (ctypes.c_int * nf)(*[f.offset for f in features]),
            (ctypes.c_int * nf)(*[f.channels for f in features]),
            (ctypes.c_float * nf)(*[f.weight for f in features]))


def instantiation(features: Sequence[RelaxFeature], c_total: int) -> str:
    """The kernel instantiation a feature layout takes on the card, as the C
    entry point dispatches it: 'relax_sweeps_kernel<true>' (the flagship's
    layout) or 'relax_sweeps_kernel<false>' (the generic one)."""
    got = build.library().relax_instantiation(c_total, len(features), *c_features(features))
    if got < 0:
        raise ValueError("the relax kernel refuses this feature layout")
    return f"relax_sweeps_kernel<{'true' if got else 'false'}>"


def _launch(labels, table, data, features, c_total, direct_cost, diagonal_cost, prog, row0,
            phases, chunks):
    """The kernel path: the label-row prologue of `table`, then one launch
    per (sub-steps, first phase) of `chunks`, ping-ponging two buffers."""
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
    if not chunks:
        return labels
    lib = build.library()
    s = build.stream()
    nf, num = len(features), table.shape[-1]
    feats = c_features(features)
    rows = torch.empty((num + 1, ROW_STRIDE), dtype=torch.float32, device=labels.device)
    build.check(lib.relax_label_rows(table.data_ptr(), rows.data_ptr(), num, c_total, nf,
                                     *feats, s), "relax_label_rows")
    bufs = (torch.empty_like(labels), torch.empty_like(labels))
    cur = labels
    for steps, phase in chunks:
        out = bufs[1] if cur is bufs[0] else bufs[0]
        build.check(lib.relax_sweeps(cur.data_ptr(), data.data_ptr(), rows.data_ptr(),
                                     out.data_ptr(), h, w, num, c_total, nf, *feats,
                                     build.ptr(prog), direct_cost, diagonal_cost, steps, phase,
                                     phases, row0, s), "relax_sweeps")
        COUNTER.launches += 1
        cur = out
    return cur


@build.on_its_card
def relax_sweeps(labels, table, data, features: Sequence[RelaxFeature], c_total: int,
                 iterations: int, direct_cost: float, diagonal_cost: float, prog=None, *,
                 phases: int = 1, row0: int = 0, return_stats: bool = False):
    """`iterations` relaxation sweeps of `phases` checkerboard sub-steps in
    'frame' stats mode -> new labels.

    labels int32 [H, W] (-1: outside the frame, never relabelled); table
    float32 [1 + 2C, L] (count | sums | sums of squares per label, K2 or
    K7); data float32 [C, H, W], the feature channels in the layout of
    `features`; prog: float32 [H] progressive-compactness factor or None;
    row0: the global row of row 0 (the parity's rows).
    With return_stats, also table_gather(table, labels) of the new labels:
    the stat image relax_phase_pallas carries (on the CPU, the plain
    version's carried image, equal to it)."""
    if labels.device.type == "cpu":
        COUNTER.plain_calls += 1
        return relax_sweeps_plain(labels, table, data, features, c_total, iterations,
                                  direct_cost, diagonal_cost, prog, return_stats, phases, row0)
    chunks = []
    for done in range(0, iterations, SWEEPS_PER_LAUNCH):
        chunks.append((min(SWEEPS_PER_LAUNCH, iterations - done) * phases, 0))
    cur = _launch(labels, table, data, features, c_total, direct_cost, diagonal_cost, prog,
                  row0, phases, chunks)
    return (cur, table_gather(table, cur)) if return_stats else cur


@build.on_its_card
def relax_phase(labels, table, data, features: Sequence[RelaxFeature], c_total: int,
                phase: int, phases: int, direct_cost: float, diagonal_cost: float, prog=None,
                *, row0: int = 0):
    """One sub-step of parity `phase` (of `phases`) from `table` -> new
    labels: a 'phase' stats-mode update, one launch (the label-row prologue
    runs on this table).  Arguments as relax_sweeps."""
    if not 0 <= phase < phases:
        raise ValueError(f"phase {phase} outside [0, {phases})")
    if labels.device.type == "cpu":
        COUNTER.plain_calls += 1
        return relax_phase_plain(labels, table, data, features, c_total, phase, phases,
                                 direct_cost, diagonal_cost, prog, row0)
    return _launch(labels, table, data, features, c_total, direct_cost, diagonal_cost, prog,
                   row0, phases, [(1, phase)])
