"""Dense optical flow (counterpart of cartslam_tpu/ops/optflow.py).

Pyramidal block matching with the reference's downstream contract: int16
[H, W, 2] in S10.5 fixed point, measured current -> previous, so that
prev_pos = cur_pos - flow.  At each pyramid level the previous image is
warped by the upsampled flow estimate, then a (2r+1)^2 local SAD search
refines it, and two 3x3 median passes regularize the field.

Every value on the way is exact in float32: the pyramid holds integers
scaled by 4^-level, the SAD sums stay far below 2^24 ulps, and the flow is
integer-valued at every level.  So the result does not depend on the order
of the sums, and the port equals the JAX function bit for bit.

Images are [..., H, W] here; the flow field is kept channel-first
([2, H, W], x then y) inside ``dense_flow`` so the median runs on both
channels at once, and is returned as [H, W, 2] like the JAX function.
"""

from __future__ import annotations

import torch

# The zero-motion bias of a candidate (dx, dy): BIAS * (|dx| + |dy|), a
# float32 product as in the JAX scan.
BIAS = 0.01


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dims."""
    h, w = x.shape[-2:]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x[..., rows[:, None], cols[None, :]]


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 mean downsample (odd trailing rows / columns drop).

    The JAX package writes it as two banded matmuls for the TPU's MXU; the
    values are dyadic and exact in any order, so the plain mean is equal.
    """
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
            + x[..., 1::2, 1::2]) * 0.25


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 box sum over the last two dims with edge padding: shift-adds
    of slices of one padded copy (the JAX function's clamped ``_shift``s).
    The JAX function takes two cumulative sums instead above r = 3; on the
    pyramid's dyadic values every partial sum is exact, so both give the
    same result."""
    h, w = x.shape[-2:]
    xp = _pad_edge(x, r, r, 0, 0)
    rows = x
    for k in range(1, r + 1):
        rows = rows + xp[..., r - k : r - k + h, :] + xp[..., r + k : r + k + h, :]
    rp = _pad_edge(rows, 0, 0, r, r)
    out = rows
    for k in range(1, r + 1):
        out = out + rp[..., :, r - k : r - k + w] + rp[..., :, r + k : r + k + w]
    return out


def _warp_backward(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample img [H, W] at (p - flow[p]) with nearest-integer, clamped
    coordinates; flow is [2, H, W] (x, y).

    This is the JAX function's gather route, which it takes on every backend
    but the TPU (there it runs the bounded select warp of ops/warp.py,
    ``select_warp_clamped``, which is not ported).
    """
    h, w = img.shape
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - flow[1]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - flow[0]
    yi = torch.round(ys).to(torch.int64).clamp(0, h - 1)
    xi = torch.round(xs).to(torch.int64).clamp(0, w - 1)
    return img[yi, xi]


def _median3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median over the last two dims (edge-clamped): one pass of the
    plain version of kernels/median.median3x3, which ``dense_flow`` calls.

    The JAX function runs Smith's 19-exchange min/max network, which keeps
    the TPU on plain vector ops; the median of 9 values is one value, so
    here one gather of the 9 neighbours and ``median`` give the same
    result.
    """
    h, w = x.shape[-2:]
    d = torch.arange(-1, 2, device=x.device)
    rows = (torch.arange(h, device=x.device)[None, :] + d[:, None]).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device)[None, :] + d[:, None]).clamp(0, w - 1)
    nb = x[..., rows[:, None, :, None], cols[None, :, None, :]]  # [..., 3, 3, h, w]
    return nb.flatten(-4, -3).median(dim=-3).values


def _search_level(cur: torch.Tensor, prev_warped: torch.Tensor, radius: int,
                  win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Best (dx, dy) in [-radius, radius]^2 per pixel by windowed SAD.

    The candidates go dy-major, then dx, as in the JAX scan form; all of
    them are one leading dimension here, and ``argmin`` takes the first
    minimum, which is the scan's strict-< acceptance.
    """
    h, w = cur.shape
    dev = cur.device
    offs = torch.arange(-radius, radius + 1, device=dev)
    dy = offs.repeat_interleave(2 * radius + 1)
    dx = offs.repeat(2 * radius + 1)
    # Candidate k samples prev at p - d_k, edge-clamped.
    rows = (torch.arange(h, device=dev)[None, :] - dy[:, None]).clamp(0, h - 1)
    cols = (torch.arange(w, device=dev)[None, :] - dx[:, None]).clamp(0, w - 1)
    cand = prev_warped[rows[:, :, None], cols[:, None, :]]  # [K, h, w]
    cost = _box_sum(torch.abs(cur[None] - cand), win)
    # float32(BIAS) * k, computed on the device (a scalar tensor made on
    # the host would be a pageable copy, which waits for the stream).
    bias = (dx.abs() + dy.abs()).float() * BIAS
    best = torch.argmin(cost + bias[:, None, None], dim=0)
    return dx.float()[best], dy.float()[best]


def _upsample2(flow: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsampling of a [2, h, w] flow field, values doubled."""
    return 2.0 * flow.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def dense_flow(cur_gray: torch.Tensor, prev_gray: torch.Tensor, *, levels: int = 4,
               search: int = 4, refine: int = 2, win: int = 2, base_level: int = 1,
               fine_refine: int = 1, med_passes: int = 2) -> torch.Tensor:
    """Gray uint8 pair [H, W] -> float32 flow [H, W, 2] (x, y),
    current -> previous.

    The finest searched level is ``base_level`` (half resolution by
    default); the result is upsampled to full resolution.  The coarsest
    level searches +-search, intermediate ones +-refine, the finest searched
    one +-fine_refine; ``med_passes`` 3x3 medians follow every level
    (kernels/median: one launch a level on the card for two passes).
    """
    # kernels/median imports this module for its plain version.
    from ..kernels.median import median3x3

    h, w = cur_gray.shape
    m = 1 << (levels - 1)
    ph, pw = (-h) % m, (-w) % m
    curs = [_pad_edge(cur_gray.to(torch.float32), 0, ph, 0, pw)]
    prevs = [_pad_edge(prev_gray.to(torch.float32), 0, ph, 0, pw)]
    for _ in range(levels - 1):
        curs.append(_avg_pool2(curs[-1]))
        prevs.append(_avg_pool2(prevs[-1]))

    flow = torch.zeros((2, *curs[-1].shape), dtype=torch.float32, device=cur_gray.device)
    for lvl in range(levels - 1, base_level - 1, -1):
        c, p = curs[lvl], prevs[lvl]
        if lvl == levels - 1:
            radius = search
            # The coarsest level's flow is identically zero: no warp.
            pw_img = p
        else:
            radius = fine_refine if lvl == base_level else refine
            flow = _upsample2(flow)[:, : c.shape[0], : c.shape[1]]
            pw_img = _warp_backward(p, flow)
        dx, dy = _search_level(c, pw_img, radius, win)
        flow = median3x3(flow + torch.stack([dx, dy]), med_passes)

    for _ in range(base_level):
        flow = _upsample2(flow)
    return flow[:, :h, :w].permute(1, 2, 0)


def flow_bound(levels: int = 4, search: int = 4, refine: int = 2, base_level: int = 1,
               fine_refine: int = 1) -> int:
    """Static bound on |flow| components at full resolution (42 px for the
    defaults), mirroring the per-level accumulation of ``dense_flow``."""
    bound = 0
    for lvl in range(levels - 1, base_level - 1, -1):
        if lvl != levels - 1:
            bound *= 2
        if lvl == levels - 1:
            bound += search
        elif lvl == base_level:
            bound += fine_refine
        else:
            bound += refine
    return bound << base_level


def to_s10_5(flow: torch.Tensor) -> torch.Tensor:
    """float flow -> int16 S10.5 fixed point (x32), the NVOF output format."""
    return torch.clamp(torch.round(flow * 32.0), -32768, 32767).to(torch.int16)
