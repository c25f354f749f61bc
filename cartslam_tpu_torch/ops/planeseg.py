"""Plane segmentation from disparity derivatives (counterpart of
ops/planeseg.py: ``classify``, ``temporal_vote``, ``temporal_vote_warped``
and ``superpixel_vote``).

Plane ids: HORIZONTAL=0, VERTICAL=1, UNKNOWN=2.  Classification tests the
horizontal range first, then the vertical range, both half-open.
"""

from __future__ import annotations

import torch

from ..kernels import tally as ktally
from ..runtime.module import Dependency
from .tally import table_gather
from .warp import separable_warp

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


def warp_coords(flow_stack: torch.Tensor, num_prev: int):
    """Chained backward-warp coordinates of the reference-faithful temporal
    vote (planeseg.cu:210-227): every flow map is sampled at the ORIGINAL
    pixel, and the integer parts (``>> 5``) are subtracted cumulatively.

    flow_stack: int16 [K, H, W, 2] S10.5 flow, [0] the current frame's
    (current -> previous), [k] the k-th previous frame's.  Returns (xs, ys)
    int32 [K, H, W], the position in the k-th previous frame, and in_bounds
    bool [K, H, W], false off the frame and for k >= num_prev."""
    k, h, w, _ = flow_stack.shape
    dev = flow_stack.device
    cx = torch.cumsum(flow_stack[..., 0].to(torch.int32) >> 5, dim=0, dtype=torch.int32)
    cy = torch.cumsum(flow_stack[..., 1].to(torch.int32) >> 5, dim=0, dtype=torch.int32)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, None, :] - cx
    ys = torch.arange(h, dtype=torch.int32, device=dev)[None, :, None] - cy
    inb = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
    inb = inb & (torch.arange(k, device=dev)[:, None, None] < num_prev)
    return xs, ys, inb


def _vote(votes, compare_unknown: bool) -> torch.Tensor:
    """Winner of per-pixel class votes: HORIZONTAL on strictly more than
    VERTICAL, else VERTICAL; UNKNOWN when the winner has fewer votes than
    UNKNOWN (compare_unknown) or none at all."""
    winner = torch.where(votes[HORIZONTAL] > votes[VERTICAL], HORIZONTAL, VERTICAL)
    wv = torch.where(winner == HORIZONTAL, votes[HORIZONTAL], votes[VERTICAL])
    unknown = wv < votes[UNKNOWN] if compare_unknown else wv == 0
    return torch.where(unknown, UNKNOWN, winner).to(torch.uint8)


def temporal_vote(current: torch.Tensor, prev_planes: torch.Tensor, flow_stack: torch.Tensor,
                  num_prev: int, current_weight: int, compare_unknown: bool) -> torch.Tensor:
    """The reference-faithful temporal majority vote: K flat gathers of the
    previous frames' planes at ``warp_coords``' positions.

    current: uint8 [H, W]; prev_planes: uint8 [K, H, W], the k-th previous
    frame's unsmoothed planes; flow_stack as warp_coords; num_prev: the
    valid history entries (min(frame_id - 1, K)), an int or a device
    scalar.  current_weight 1 with
    compare_unknown False is the pixel module's rule (planeseg.cu:203-238),
    2 with True the superpixel module's (sp_planeseg.cu:82-116)."""
    h, w = current.shape
    xs, ys, inb = warp_coords(flow_stack, num_prev)
    k = prev_planes.shape[0]
    idx = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).reshape(k, h * w).to(torch.int64)
    sampled = torch.gather(prev_planes.reshape(k, h * w), 1, idx).reshape(k, h, w)
    votes = [((sampled == plane) & inb).sum(dim=0, dtype=torch.int32)
             + torch.where(current == plane, current_weight, 0)
             for plane in range(PLANE_COUNT)]
    return _vote(votes, compare_unknown)


TEMPORAL_MODES = ("carried", "faithful")


def temporal_dependencies(mode: str, distance: int, flow_key: str, planes_key: str) -> list:
    """The history a temporal vote reads.  'faithful' (the reference's set,
    include/modules/planeseg.hpp:127-137): the flow now and at -1..-(K-1)
    and the unsmoothed planes at -1..-K.  'carried': the flow now and the
    planes at -1 (its accumulator holds the rest)."""
    deps = [Dependency(flow_key)]
    if mode == "faithful":
        deps += [Dependency(flow_key, offset=-i) for i in range(1, distance)]
        deps += [Dependency(planes_key, offset=-i) for i in range(1, distance + 1)]
    else:
        deps.append(Dependency(planes_key, offset=-1))
    return deps


def temporal_vote_from_history(current, step, flow, distance: int, flow_key: str,
                               planes_key: str, current_weight: int, compare_unknown: bool):
    """temporal_vote over the step's history rings: the flows now and at
    -1..-(K-1), the planes at -1..-K, and num_prev = min(frame_id - 1, K),
    clamped on the device."""
    flows = [flow] + [step.history(flow_key, -i) for i in range(1, distance)]
    prevs = [step.history(planes_key, -i) for i in range(1, distance + 1)]
    return temporal_vote(current, torch.stack(prevs), torch.stack(flows),
                         torch.clamp(step.frame_id - 1, max=distance), current_weight,
                         compare_unknown)


WARP_INVALID = 3  # 2-bit sentinel: "no vote" (out of the image or before frame 1)
WARP_MODES = ("auto", "gather", "select")


def temporal_vote_warped(current: torch.Tensor, prev_planes: torch.Tensor,
                         warp_state: torch.Tensor, flow: torch.Tensor, current_weight: int,
                         compare_unknown: bool, warp_mode: str = "auto",
                         max_warp_y: int = 32, max_warp_x: int = 64,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Temporal majority vote through a carried warp accumulator.

    Instead of re-warping every previous frame's labels, the already-warped
    vote stack is carried across frames and warped once by the current
    flow: V_k(t) = warp_{f_t}(V_{k-1}(t-1)), V_0 := planes(t-1).  All K
    channels pack as 2-bit fields into one int32 image, so one image warps
    whatever K is.  The integer part of the S10.5 flow is ``>> 5``.

    current: uint8 [H, W]; prev_planes: uint8 [H, W] (the previous frame's
    unsmoothed planes); warp_state: uint8 [K, H, W], channel c = planes of
    frame t-1-c warped into frame t-1, WARP_INVALID where no vote exists;
    flow: int16 [H, W, 2].  current_weight and compare_unknown as in the
    JAX function (2 and True for the superpixel module).
    warp_mode: 'gather' warps each pixel by its flow, unbounded; 'select' is
    the JAX package's TPU route, a separable warp (ops/warp.py) that drops
    votes moving farther than (max_warp_y, max_warp_x); 'auto' is 'gather',
    as on every backend of the JAX package but the TPU.

    Returns (voted uint8 [H, W], new warp_state uint8 [K, H, W]).
    """
    k, h, w = warp_state.shape
    if 2 * (k + 1) > 32:
        raise ValueError(f"temporal distance {k} exceeds the 2-bit pack limit of 15")
    if warp_mode not in WARP_MODES:
        raise ValueError(f"unknown warp_mode {warp_mode!r}; expected one of {WARP_MODES}")
    stack_in = torch.cat([prev_planes[None], warp_state[:-1]], dim=0).to(torch.int32)
    packed = torch.zeros((h, w), dtype=torch.int32, device=current.device)
    all_invalid = 0
    for c in range(k):
        packed = packed | (stack_in[c] << (2 * c))
        all_invalid |= WARP_INVALID << (2 * c)

    fx = flow[..., 0].to(torch.int32) >> 5
    fy = flow[..., 1].to(torch.int32) >> 5
    if warp_mode == "select":
        warped, _ = separable_warp(packed, fy, fx, max_warp_y, max_warp_x, fill=all_invalid)
    else:
        ys = torch.arange(h, dtype=torch.int32, device=current.device)[:, None] - fy
        xs = torch.arange(w, dtype=torch.int32, device=current.device)[None, :] - fx
        inb = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
        idx = ys.clamp(0, h - 1).to(torch.int64) * w + xs.clamp(0, w - 1)
        warped = torch.where(inb, packed.reshape(-1)[idx], all_invalid)

    new_state = torch.stack([((warped >> (2 * c)) & 3).to(torch.uint8) for c in range(k)])
    votes = [(new_state == plane).sum(dim=0, dtype=torch.int32)
             + torch.where(current == plane, current_weight, 0)
             for plane in range(PLANE_COUNT)]
    return _vote(votes, compare_unknown), new_state


def superpixel_vote(pixel_planes: torch.Tensor, labels: torch.Tensor,
                    num_labels: int, psum=None) -> torch.Tensor:
    """Per-label class counts (kernel K4), winner per label (UNKNOWN, then
    VERTICAL on strictly more votes, then HORIZONTAL on strictly more than
    the running max), painted back to the pixels as uint8.  psum (spatial
    mode): the shards' counts are summed before the winner pass, exact
    integers, so equal to the full frame's for any shard count."""
    counts = ktally.vote_tally(labels.to(torch.int32).contiguous(),
                               pixel_planes.reshape(labels.shape).contiguous(), num_labels,
                               PLANE_COUNT)
    if psum is not None:
        counts = psum(counts)
    best = torch.full((num_labels,), UNKNOWN, dtype=torch.int32, device=labels.device)
    best_votes = counts[:, UNKNOWN]
    take_v = counts[:, VERTICAL] > best_votes
    best = torch.where(take_v, VERTICAL, best)
    best_votes = torch.where(take_v, counts[:, VERTICAL], best_votes)
    take_h = counts[:, HORIZONTAL] > best_votes
    best = torch.where(take_h, HORIZONTAL, best)
    return table_gather(best, labels).to(torch.uint8)
