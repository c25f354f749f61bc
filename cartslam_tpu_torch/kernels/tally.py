"""Kernels K2 (moment tally), K4 (vote tally) and K7 (label tally),
csrc/tally.cu, with their plain versions.

K2 replaces the Pallas ``moment_tally_pallas`` (cartslam_tpu/ops/pallas/
tally.py:231); K4 replaces ``vote_tally_pallas`` (ops/pallas/tally.py:102);
K7 replaces ``label_tally_pallas`` (ops/pallas/tally.py:318).  On a CUDA
tensor the wrappers launch the kernel or raise; on a CPU tensor they run the
plain version.  Both versions compute exact integer sums: K2's and K7's
table entries are int64 sums rounded to float32 once (the JAX CPU path adds
in float32, exact only below 2^24 per entry).

K2, K4 and K7 take their labels in the image's layout, [..., W] (an image's
[H, W], or a flat [N]), and their data in the same layout behind the
channel axis; K7, like K2, returns its table channel-major, [C, L].  The
layout only places the kernels' tiles (``tiling``): a block keeps the labels
of a 16-row x 128-pixel tile in shared memory, and superpixel labels are
coherent in 2-D, not along a flat index.  The plain
versions take the flat arrays (K7's: labels [B] and values [B, C], the JAX
function's form).

``reduce`` (K2 and K7): a function applied to the exact int64 table before
it is rounded to float32.  The height-sharded mode passes its psum there, so
the shards' tables are summed exactly and rounded once, as the full frame's
table is; a psum of the rounded float32 tables would differ in the low bits
wherever an entry passes 2^24 (full-size coordinate squares do).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from . import build

MOMENT_COUNTER = build.counter("moment_tally")
VOTE_COUNTER = build.counter("vote_tally")
LABEL_COUNTER = build.counter("label_tally")
MAX_CHANNELS = 8
# K2's data domain on the card (moment_tally_pallas's): the kernel's 32-bit
# per-tile slot sums are exact for values in [-32768, 32767].
DATA_MIN, DATA_MAX = -32768, 32767
# K2's, K4's and K7's tiles (csrc/tally.cu): TILE_ROWS rows of TILE_QUADS quads of
# 4 pixels.
TILE_ROWS, TILE_QUADS = 16, 32


@dataclasses.dataclass(frozen=True)
class Tiling:
    """K2's and K4's tiles over n pixels: quad rows `quads_per_row` quads
    wide, tiles of TILE_ROWS x TILE_QUADS quads, `cols` to a row of tiles,
    `count` in all."""

    quads_per_row: int
    cols: int
    count: int


def tiling(shape: Sequence[int]) -> Tiling:
    """The tiles of a label array of `shape`: [..., W] rows of W pixels
    (rounded up to whole quads; a row that is not a multiple of 4 only
    shifts the quads against the image's rows), a flat [N] in contiguous
    chunks of TILE_ROWS x TILE_QUADS quads."""
    quads = -(-math.prod(shape) // 4)
    wq = max(-(-shape[-1] // 4), 1) if len(shape) > 1 else TILE_QUADS
    rows = -(-quads // wq)
    cols = -(-wq // TILE_QUADS)
    return Tiling(wq, cols, -(-rows // TILE_ROWS) * cols)


def moment_scratch(channels: int, num_labels: int, reduce) -> tuple[tuple, tuple | None]:
    """Shapes of K2's int64 table and its float32 output (None when a
    `reduce` takes the int64 table)."""
    shape = (1 + 2 * channels, num_labels)
    return shape, (None if reduce is not None else shape)


def _rounded(acc: torch.Tensor, reduce) -> torch.Tensor:
    return (acc if reduce is None else reduce(acc)).to(torch.float32)


def _rounded_on_card(lib, acc: torch.Tensor, reduce) -> torch.Tensor:
    """float32 of reduce(acc) through the kernels' own rounding step."""
    acc = reduce(acc).contiguous()
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    build.check(lib.tally_to_float(acc.data_ptr(), out.data_ptr(), acc.numel(),
                                   build.stream()), "tally_to_float")
    return out


def moment_tally_plain(labels: torch.Tensor, data: torch.Tensor, num_labels: int,
                       reduce=None) -> torch.Tensor:
    """labels int32 [N], data int32 [C, N] -> float32 [1 + 2C, L]:
    per-label count | per-channel sums | per-channel sums of squares.
    Labels outside [0, L) drop."""
    keep = (labels >= 0) & (labels < num_labels)
    idx = labels[keep].to(torch.int64)
    d = data[:, keep].to(torch.int64)
    rows = torch.cat([torch.ones_like(d[:1]), d, d * d], dim=0)
    acc = torch.zeros((rows.shape[0], num_labels), dtype=torch.int64, device=labels.device)
    return _rounded(acc.index_add_(1, idx, rows), reduce)


@build.on_its_card
def moment_tally(labels: torch.Tensor, data: torch.Tensor, num_labels: int,
                 reduce=None) -> torch.Tensor:
    """moment_tally_plain's table from labels int32 [..., W] and data int32
    [C, ..., W] (C <= 8) of the same layout.  On the card the data must lie
    in [DATA_MIN, DATA_MAX], the TPU kernel's domain (every plane init_stats
    tallies does: derivatives with their -32768 invalid, colours,
    coordinates); the plain version is exact on any int32."""
    if labels.device.type == "cpu":
        MOMENT_COUNTER.plain_calls += 1
        return moment_tally_plain(labels.reshape(-1), data.reshape(data.shape[0], -1),
                                  num_labels, reduce)
    c = data.shape[0]
    if c > MAX_CHANNELS:
        raise ValueError(f"moment tally kernel takes at most {MAX_CHANNELS} channels, got {c}")
    build.expect(labels, "labels", torch.int32)
    build.expect(data, "data", torch.int32, (c, *labels.shape), labels.device)
    tiles = tiling(labels.shape)
    acc_shape, out_shape = moment_scratch(c, num_labels, reduce)
    acc = torch.empty(acc_shape, dtype=torch.int64, device=labels.device)
    out = None if out_shape is None else torch.empty(out_shape, dtype=torch.float32,
                                                     device=labels.device)
    lib = build.library()
    build.check(lib.moment_tally(labels.data_ptr(), data.data_ptr(), labels.numel(), c,
                                 num_labels, tiles.quads_per_row, tiles.cols, tiles.count,
                                 acc.data_ptr(), build.ptr(out), build.stream()),
                "moment_tally")
    MOMENT_COUNTER.launches += 1
    return out if reduce is None else _rounded_on_card(lib, acc, reduce)


def vote_tally_plain(labels: torch.Tensor, votes: torch.Tensor, num_labels: int,
                     num_classes: int) -> torch.Tensor:
    """labels int32 [N], votes uint8 [N] -> int32 [L, P] class counts."""
    v = votes.to(torch.int64)
    keep = (labels >= 0) & (labels < num_labels) & (v < num_classes)
    idx = labels[keep].to(torch.int64) * num_classes + v[keep]
    counts = torch.bincount(idx, minlength=num_labels * num_classes)
    return counts.view(num_labels, num_classes).to(torch.int32)


@build.on_its_card
def vote_tally(labels: torch.Tensor, votes: torch.Tensor, num_labels: int,
               num_classes: int) -> torch.Tensor:
    """vote_tally_plain's counts from labels int32 [..., W] and votes uint8
    of the same shape."""
    if labels.device.type == "cpu":
        VOTE_COUNTER.plain_calls += 1
        return vote_tally_plain(labels.reshape(-1), votes.reshape(-1), num_labels, num_classes)
    build.expect(labels, "labels", torch.int32)
    build.expect(votes, "votes", torch.uint8, tuple(labels.shape), labels.device)
    tiles = tiling(labels.shape)
    out = torch.empty((num_labels, num_classes), dtype=torch.int32, device=labels.device)
    build.check(build.library().vote_tally(
        labels.data_ptr(), votes.data_ptr(), labels.numel(), num_labels, num_classes,
        tiles.quads_per_row, tiles.cols, tiles.count, out.data_ptr(), build.stream()),
        "vote_tally")
    VOTE_COUNTER.launches += 1
    return out


def label_tally_plain(labels: torch.Tensor, values: torch.Tensor, num_labels: int,
                      reduce=None) -> torch.Tensor:
    """labels int32 [B], values int32 [B, C] -> float32 [L, C] per-label
    column sums; labels outside [0, L) drop."""
    return _rounded(_label_sums(labels, values, num_labels), reduce)


def _label_sums(labels: torch.Tensor, values: torch.Tensor, num_labels: int) -> torch.Tensor:
    """The exact int64 [L, C] sums of label_tally_plain."""
    keep = (labels >= 0) & (labels < num_labels)
    acc = torch.zeros((num_labels, values.shape[1]), dtype=torch.int64, device=labels.device)
    return acc.index_add_(0, labels[keep].to(torch.int64), values[keep].to(torch.int64))


@build.on_its_card
def label_tally(labels: torch.Tensor, values: torch.Tensor, num_labels: int,
                reduce=None) -> torch.Tensor:
    """Per-label sums of C columns, channel-major: float32 [C, L] from labels
    int32 [..., W] and values int32 [C, ..., W] of the same layout (any
    int32 values), the transpose of label_tally_plain's table; `reduce`
    takes the int64 table [C, L].  The layout places the tiles, as K2's."""
    c = values.shape[0]
    if labels.device.type == "cpu":
        LABEL_COUNTER.plain_calls += 1
        sums = _label_sums(labels.reshape(-1), values.reshape(c, -1).T, num_labels)
        return _rounded(sums.T.contiguous(), reduce)
    build.expect(labels, "labels", torch.int32)
    build.expect(values, "values", torch.int32, (c, *labels.shape), labels.device)
    tiles = tiling(labels.shape)
    lib = build.library()
    acc = torch.empty((c, num_labels), dtype=torch.int64, device=labels.device)
    out = None if reduce is not None else torch.empty(
        (c, num_labels), dtype=torch.float32, device=labels.device)
    build.check(lib.label_tally(labels.data_ptr(), values.data_ptr(), labels.numel(), c,
                                num_labels, tiles.quads_per_row, tiles.cols, tiles.count,
                                acc.data_ptr(), build.ptr(out), build.stream()),
                "label_tally")
    LABEL_COUNTER.launches += 1
    return out if reduce is None else _rounded_on_card(lib, acc, reduce)
