"""Kernels K2 (moment tally), K4 (vote tally) and K7 (label tally),
csrc/tally.cu, with their plain versions.

K2 replaces the Pallas ``moment_tally_pallas`` (cartslam_tpu/ops/pallas/
tally.py:231); K4 replaces ``vote_tally_pallas`` (ops/pallas/tally.py:102);
K7 replaces ``label_tally_pallas`` (ops/pallas/tally.py:318).  On a CUDA
tensor the wrappers launch the kernel or raise; on a CPU tensor they run the
plain version.  Both versions compute exact integer sums: K2's and K7's
table entries are int64 sums rounded to float32 once (the JAX CPU path adds
in float32, exact only below 2^24 per entry).

``reduce`` (K2 and K7): a function applied to the exact int64 table before
it is rounded to float32.  The height-sharded mode passes its psum there, so
the shards' tables are summed exactly and rounded once, as the full frame's
table is; a psum of the rounded float32 tables would differ in the low bits
wherever an entry passes 2^24 (full-size coordinate squares do).
"""

from __future__ import annotations

import torch

from . import build

MOMENT_COUNTER = build.counter("moment_tally")
VOTE_COUNTER = build.counter("vote_tally")
LABEL_COUNTER = build.counter("label_tally")
MAX_CHANNELS = 8


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


def moment_tally(labels: torch.Tensor, data: torch.Tensor, num_labels: int,
                 reduce=None) -> torch.Tensor:
    if labels.device.type == "cpu":
        MOMENT_COUNTER.plain_calls += 1
        return moment_tally_plain(labels, data, num_labels, reduce)
    c, n = data.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"moment tally kernel takes at most {MAX_CHANNELS} channels, got {c}")
    build.expect(labels, "labels", torch.int32, (n,))
    build.expect(data, "data", torch.int32, (c, n), labels.device)
    lib = build.library()
    acc = torch.empty((1 + 2 * c, num_labels), dtype=torch.int64, device=labels.device)
    out = None if reduce is not None else torch.empty(
        (1 + 2 * c, num_labels), dtype=torch.float32, device=labels.device)
    build.check(lib.moment_tally(labels.data_ptr(), data.data_ptr(), n, c, num_labels,
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


def vote_tally(labels: torch.Tensor, votes: torch.Tensor, num_labels: int,
               num_classes: int) -> torch.Tensor:
    if labels.device.type == "cpu":
        VOTE_COUNTER.plain_calls += 1
        return vote_tally_plain(labels, votes, num_labels, num_classes)
    (n,) = labels.shape
    build.expect(labels, "labels", torch.int32, (n,))
    build.expect(votes, "votes", torch.uint8, (n,), labels.device)
    lib = build.library()
    out = torch.empty((num_labels, num_classes), dtype=torch.int32, device=labels.device)
    build.check(lib.vote_tally(labels.data_ptr(), votes.data_ptr(), n, num_labels,
                               num_classes, out.data_ptr(), build.stream()),
                "vote_tally")
    VOTE_COUNTER.launches += 1
    return out


def label_tally_plain(labels: torch.Tensor, values: torch.Tensor, num_labels: int,
                      reduce=None) -> torch.Tensor:
    """labels int32 [B], values int32 [B, C] -> float32 [L, C] per-label
    column sums; labels outside [0, L) drop."""
    keep = (labels >= 0) & (labels < num_labels)
    acc = torch.zeros((num_labels, values.shape[1]), dtype=torch.int64, device=labels.device)
    acc.index_add_(0, labels[keep].to(torch.int64), values[keep].to(torch.int64))
    return _rounded(acc, reduce)


def label_tally(labels: torch.Tensor, values: torch.Tensor, num_labels: int,
                reduce=None) -> torch.Tensor:
    if labels.device.type == "cpu":
        LABEL_COUNTER.plain_calls += 1
        return label_tally_plain(labels, values, num_labels, reduce)
    b, c = values.shape
    build.expect(labels, "labels", torch.int32, (b,))
    build.expect(values, "values", torch.int32, (b, c), labels.device)
    lib = build.library()
    acc = torch.empty((num_labels, c), dtype=torch.int64, device=labels.device)
    out = None if reduce is not None else torch.empty(
        (num_labels, c), dtype=torch.float32, device=labels.device)
    build.check(lib.label_tally(labels.data_ptr(), values.data_ptr(), b, c, num_labels,
                                acc.data_ptr(), build.ptr(out), build.stream()),
                "label_tally")
    LABEL_COUNTER.launches += 1
    return out if reduce is None else _rounded_on_card(lib, acc, reduce)
