"""Plain PyTorch operations of the superpixel plane-segmentation chain.

This is the benchmark's own copy of the port's plain versions (the XLA-level
formulation of each CUDA kernel, in PyTorch operations), reduced to what
the benchmark's configurations run: census and 4-path SGM with WTA,
uniqueness, subpixel and the left-right check; the disparity smoothing; the
directional derivatives and their histogram; pyramidal block-matching
flow; contour-relaxation superpixels in 'frame' statistics mode; the pixel
classification, the carried flow-warped temporal vote ('gather' warp) and
the per-superpixel majority vote.  It imports nothing of the program, so a
change to the program cannot change what it is held to.

Integer outputs are exact.  Every float operation is a separate PyTorch
operation in the program's order, so the float32 results equal the
program's bit for bit where the formulas are the same.  ``fdt`` is the
float type of the colour conversions, the flow and the relaxation costs:
float32 is the reference; a lower precision (bfloat16) is the control that
the comparison has to reject.

Two departures from the copied code, neither of which changes a value: the
SGM path scans run both directions of an axis as one batch (integer
arithmetic, so the order does not matter), and the spatial-mode, phase and
select-warp branches are gone.
"""

from __future__ import annotations

import math

import torch

DISPARITY_INVALID = -32768
DERIVATIVE_INVALID = -32768
CENSUS_WH, CENSUS_HT = 9, 7
COST_INVALID = 62
BIG16 = 32767

HORIZONTAL, VERTICAL, UNKNOWN, PLANE_COUNT = 0, 1, 2, 3
WARP_INVALID = 3
OOB = -1


# ------------------------------------------------------------------ colour

def bgr_to_gray(img: torch.Tensor, fdt=torch.float32) -> torch.Tensor:
    """BGR uint8 [H, W, 3] -> gray uint8 (OpenCV BT.601 weights)."""
    f = img.to(fdt)
    y = f[..., 0] * 0.114 + f[..., 1] * 0.587 + f[..., 2] * 0.299
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def bgr_to_ycrcb(img: torch.Tensor, fdt=torch.float32) -> torch.Tensor:
    """BGR uint8 [H, W, 3] -> YCrCb uint8 [H, W, 3] (OpenCV constants)."""
    f = img.to(fdt)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = b * 0.114 + g * 0.587 + r * 0.299
    cr = (r - y) * 0.713 + 128.0
    cb = (b - y) * 0.564 + 128.0
    return torch.clamp(torch.round(torch.stack([y, cr, cb], dim=-1)), 0, 255).to(torch.uint8)


# ----------------------------------------------------------------- stereo

def pad_edge(x: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dims."""
    h, w = x.shape[-2:]
    rows = torch.arange(-py, h + py, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-px, w + px, device=x.device).clamp(0, w - 1)
    return x[..., rows, :][..., cols]


def census_transform(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """9x7 census -> two int32 words; bit k set when the k-th neighbour
    (row-major, centre skipped) is strictly greater than the centre."""
    g = gray.to(torch.int32)
    ph, pw = CENSUS_HT // 2, CENSUS_WH // 2
    padded = pad_edge(g, ph, pw)
    h, w = g.shape
    words = [torch.zeros_like(g), torch.zeros_like(g)]
    bit = 0
    for dy in range(-ph, ph + 1):
        for dx in range(-pw, pw + 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[dy + ph: dy + ph + h, dx + pw: dx + pw + w]
            b = (nb > g).to(torch.int32)
            words[bit // 31] = words[bit // 31] | (b << (bit % 31))
            bit += 1
    return words[0], words[1]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def cost_volume(left_census, right_census, min_disparity: int, num_disparities: int,
                chunk: int = 32):
    """uint8 [D, H, W]: hamming(censusL[x], censusR[x - d]); COST_INVALID
    where x - d leaves the image.  `chunk` disparities at a time."""
    l0, l1 = left_census
    r0, r1 = right_census
    h, w = l0.shape
    cols = torch.arange(w, device=l0.device)
    out = torch.empty((num_disparities, h, w), dtype=torch.uint8, device=l0.device)
    for c0 in range(0, num_disparities, chunk):
        d = min_disparity + torch.arange(c0, min(c0 + chunk, num_disparities),
                                         device=l0.device)
        src = cols[None, :] - d[:, None]  # [k, W]: the right view's column
        idx = src.clamp(min=0)
        c = (popcount32(l0[None] ^ r0[:, idx].permute(1, 0, 2))
             + popcount32(l1[None] ^ r1[:, idx].permute(1, 0, 2)))
        out[c0: c0 + len(d)] = torch.where((src >= 0)[:, None, :], c, COST_INVALID)
    return out


def _scan_both_ways(cost_srd: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """The path recurrence along axis 0 of [S, R, D] forwards and
    backwards, as one batch, summed: int32 [S, R, D].

    L(p,d) = C(p,d) + min(L(p-1,d), L(p-1,d+-1)+P1, min_d' L(p-1,d')+P2)
           - min_d' L(p-1,d'), from a zero carry."""
    cost = torch.stack([cost_srd, cost_srd.flip(0)])  # [2, S, R, D]
    big = torch.full_like(cost[:, 0, :, :1], 1 << 20, dtype=torch.int32)
    carry = torch.zeros_like(cost[:, 0], dtype=torch.int32)
    out = torch.empty_like(cost, dtype=torch.int32)
    for s in range(cost.shape[1]):
        m = carry.min(dim=-1, keepdim=True).values
        dn = torch.cat([big, carry[..., :-1]], dim=-1)
        up = torch.cat([carry[..., 1:], big], dim=-1)
        best = torch.minimum(torch.minimum(carry, torch.minimum(dn, up) + p1), m + p2)
        carry = cost[:, s].to(torch.int32) + best - m
        out[:, s] = carry
    return out[0] + out[1].flip(0)


def sgm_aggregate(cost_dhw: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """Sum of the 4 directional path aggregations -> int32 [H, W, D]."""
    chwd = cost_dhw.permute(1, 2, 0)
    horizontal = _scan_both_ways(chwd.permute(1, 0, 2), p1, p2).permute(1, 0, 2)
    return horizontal + _scan_both_ways(chwd, p1, p2)


def _wta(s_hwd: torch.Tensor, min_disparity: int, uniqueness: int):
    """Winner (lowest d on ties), uniqueness test and quadratic subpixel
    fit in 1/16 px -> (disp16, best, unique_ok)."""
    d = s_hwd.shape[-1]
    dt = torch.arange(d, device=s_hwd.device)
    min_key = (s_hwd * d + dt).min(dim=-1).values
    best = torch.remainder(min_key, d)
    min_s = torch.div(min_key, d, rounding_mode="floor")
    near = (dt - best[..., None]).abs() <= 1
    second = torch.where(near, BIG16, s_hwd).min(dim=-1).values
    unique_ok = second * (100 - uniqueness) >= min_s * 100
    sm = torch.gather(s_hwd, -1, (best - 1).clamp(min=0)[..., None])[..., 0]
    sp = torch.gather(s_hwd, -1, (best + 1).clamp(max=d - 1)[..., None])[..., 0]
    denom2 = torch.clamp(sm + sp - 2 * min_s, min=1)
    delta = torch.div((sm - sp) * 16 + denom2, denom2 * 2, rounding_mode="floor")
    delta = torch.where((best > 0) & (best < d - 1), delta, 0)
    return (best + min_disparity) * 16 + delta, best, unique_ok


def _lr_agreement(s_hwd: torch.Tensor, best: torch.Tensor, min_disparity: int):
    """Left-right check from the one aggregated volume."""
    h, w, d = s_hwd.shape
    dt = torch.arange(d, device=s_hwd.device)
    cols = torch.arange(w, device=s_hwd.device)
    src = cols[:, None] + dt[None, :] + min_disparity
    inb = src < w
    idx = src.clamp(max=w - 1)[None].expand(h, w, d)
    sheared = torch.where(inb[None], torch.gather(s_hwd, 1, idx), BIG16)
    best_r = torch.remainder((sheared * d + dt).min(dim=-1).values, d)
    xr = cols[None, :] - best - min_disparity
    br = torch.gather(best_r, 1, xr.clamp(min=0))
    return (xr >= 0) & ((br - best).abs() <= 1)


def sgm_disparity(left_gray, right_gray, *, min_disparity: int, num_disparities: int,
                  p1: int, p2: int, uniqueness: int) -> torch.Tensor:
    """Gray uint8 pair -> int16 x16 disparity (-32768 invalid), subpixel and
    left-right check on."""
    cl, cr = census_transform(left_gray), census_transform(right_gray)
    w = left_gray.shape[1]
    s = sgm_aggregate(cost_volume(cl, cr, min_disparity, num_disparities), p1, p2)
    disp16, best, valid = _wta(s, min_disparity, uniqueness)
    cols = torch.arange(w, device=left_gray.device)[None, :]
    valid = valid & (cols >= best + min_disparity) & _lr_agreement(s, best, min_disparity)
    return torch.where(valid, disp16, DISPARITY_INVALID).to(torch.int16)


def _box_sum_clamped(x: torch.Tensor, r: int) -> torch.Tensor:
    k = 2 * r - 1
    h, w = x.shape
    xp = pad_edge(x, r - 1, r - 1)
    rows = sum(xp[i: i + h] for i in range(k))
    return sum(rows[:, j: j + w] for j in range(k))


def interpolate(disparity: torch.Tensor, *, radius: int, iterations: int,
                min_disparity: int, max_disparity: int) -> torch.Tensor:
    """Smoothing: the floor mean of the valid values of the (2r-1)^2 window
    where more than r^2 + 1 are valid, else invalid; validity = value in
    (min_disparity, max_disparity)."""
    min_count = radius * radius + 1
    disp = disparity
    for _ in range(iterations):
        d = disp.to(torch.int32)
        valid = (d > min_disparity) & (d < max_disparity)
        s = _box_sum_clamped(torch.where(valid, d, 0), radius)
        n = _box_sum_clamped(valid.to(torch.int32), radius)
        avg = torch.div(s, torch.clamp(n, min=1), rounding_mode="floor")
        disp = torch.where(n > min_count, avg, DISPARITY_INVALID).to(torch.int16)
    return disp


# ------------------------------------------------------------- derivative

def _clamped_shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = x.shape
    py, px = abs(dy), abs(dx)
    return pad_edge(x, py, px)[py + dy: py + dy + h, px + dx: px + dx + w]


def hist256(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int32 [256]: counts of values in [-128, 127] where valid."""
    keep = valid & (values >= -128) & (values <= 127)
    v = torch.where(keep, values, -1024).to(torch.float32)
    return torch.histc(v, bins=256, min=-128, max=128).to(torch.int32)


def directional_derivatives(disparity: torch.Tensor):
    """int16 [H, W] -> (int16 [H, W, 2] vertical | horizontal central
    differences at +-2 with int16 wrap-around, int32 [256, 2] histograms)."""
    d = disparity.to(torch.int32)
    up, dn = _clamped_shift(d, -2, 0), _clamped_shift(d, 2, 0)
    lf, rt = _clamped_shift(d, 0, -2), _clamped_shift(d, 0, 2)
    vert = torch.remainder(dn - up + 32768, 65536) - 32768
    horz = torch.remainder(rt - lf + 32768, 65536) - 32768
    vert_valid = (up != DISPARITY_INVALID) & (dn != DISPARITY_INVALID)
    horz_valid = (lf != DISPARITY_INVALID) & (rt != DISPARITY_INVALID)
    out_v = torch.where(vert_valid, vert, DERIVATIVE_INVALID).to(torch.int16)
    out_h = torch.where(horz_valid, horz, DERIVATIVE_INVALID).to(torch.int16)
    hist = torch.stack([hist256(vert, vert_valid), hist256(horz, horz_valid)], dim=-1)
    return torch.stack([out_v, out_h], dim=-1), hist


# ------------------------------------------------------------------- flow

def _pad_edge4(x, top, bottom, left, right):
    h, w = x.shape[-2:]
    rows = torch.arange(-top, h + bottom, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=x.device).clamp(0, w - 1)
    return x[..., rows[:, None], cols[None, :]]


def _avg_pool2(x):
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
            + x[..., 1::2, 1::2]) * 0.25


def _box_sum(x, r):
    h, w = x.shape[-2:]
    xp = _pad_edge4(x, r, r, 0, 0)
    rows = x
    for k in range(1, r + 1):
        rows = rows + xp[..., r - k: r - k + h, :] + xp[..., r + k: r + k + h, :]
    rp = _pad_edge4(rows, 0, 0, r, r)
    out = rows
    for k in range(1, r + 1):
        out = out + rp[..., :, r - k: r - k + w] + rp[..., :, r + k: r + k + w]
    return out


def _warp_backward(img, flow):
    h, w = img.shape
    ys = torch.arange(h, dtype=img.dtype, device=img.device)[:, None] - flow[1]
    xs = torch.arange(w, dtype=img.dtype, device=img.device)[None, :] - flow[0]
    yi = torch.round(ys).to(torch.int64).clamp(0, h - 1)
    xi = torch.round(xs).to(torch.int64).clamp(0, w - 1)
    return img[yi, xi]


def _median3x3(x):
    h, w = x.shape[-2:]
    d = torch.arange(-1, 2, device=x.device)
    rows = (torch.arange(h, device=x.device)[None, :] + d[:, None]).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device)[None, :] + d[:, None]).clamp(0, w - 1)
    nb = x[..., rows[:, None, :, None], cols[None, :, None, :]]
    return nb.flatten(-4, -3).median(dim=-3).values


def _search_level(cur, prev_warped, radius, win):
    h, w = cur.shape
    dev = cur.device
    offs = torch.arange(-radius, radius + 1, device=dev)
    dy = offs.repeat_interleave(2 * radius + 1)
    dx = offs.repeat(2 * radius + 1)
    rows = (torch.arange(h, device=dev)[None, :] - dy[:, None]).clamp(0, h - 1)
    cols = (torch.arange(w, device=dev)[None, :] - dx[:, None]).clamp(0, w - 1)
    cand = prev_warped[rows[:, :, None], cols[:, None, :]]
    cost = _box_sum(torch.abs(cur[None] - cand), win)
    bias = (dx.abs() + dy.abs()).to(cur.dtype) * 0.01
    best = torch.argmin(cost + bias[:, None, None], dim=0)
    return dx.to(cur.dtype)[best], dy.to(cur.dtype)[best]


def _upsample2(flow):
    return 2.0 * flow.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def dense_flow(cur_gray, prev_gray, *, levels: int, search: int, refine: int,
               base_level: int, fine_refine: int, med_passes: int, win: int = 2,
               fdt=torch.float32) -> torch.Tensor:
    """Gray uint8 pair -> flow [H, W, 2] (x, y), current -> previous:
    pyramidal SAD block matching with 3x3 medians after every level."""
    h, w = cur_gray.shape
    m = 1 << (levels - 1)
    ph, pw = (-h) % m, (-w) % m
    curs = [_pad_edge4(cur_gray.to(fdt), 0, ph, 0, pw)]
    prevs = [_pad_edge4(prev_gray.to(fdt), 0, ph, 0, pw)]
    for _ in range(levels - 1):
        curs.append(_avg_pool2(curs[-1]))
        prevs.append(_avg_pool2(prevs[-1]))
    flow = torch.zeros((2, *curs[-1].shape), dtype=fdt, device=cur_gray.device)
    for lvl in range(levels - 1, base_level - 1, -1):
        c, p = curs[lvl], prevs[lvl]
        if lvl == levels - 1:
            radius, pw_img = search, p
        else:
            radius = fine_refine if lvl == base_level else refine
            flow = _upsample2(flow)[:, : c.shape[0], : c.shape[1]]
            pw_img = _warp_backward(p, flow)
        dx, dy = _search_level(c, pw_img, radius, win)
        flow = flow + torch.stack([dx, dy])
        for _ in range(med_passes):
            flow = _median3x3(flow)
    for _ in range(base_level):
        flow = _upsample2(flow)
    return flow[:, :h, :w].permute(1, 2, 0)


def to_s10_5(flow: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(flow.to(torch.float32) * 32.0), -32768, 32767).to(torch.int16)


# ------------------------------------------------------------ superpixels

def block_grid(height: int, width: int, block: int, device) -> tuple[torch.Tensor, int]:
    """(labels int32 [H, W] of the block grid, number of blocks)."""
    bx, by = -(-width // block), -(-height // block)
    ys = torch.arange(height, dtype=torch.int32, device=device)[:, None] // block
    xs = torch.arange(width, dtype=torch.int32, device=device)[None, :] // block
    return (ys * bx + xs).to(torch.int32), bx * by


def moment_table(labels: torch.Tensor, data: torch.Tensor, num_labels: int, fdt) -> torch.Tensor:
    """[1 + 2C, L]: per-label count | sums | sums of squares of the int32
    planes data [C, H, W], exact in int64, rounded once."""
    lab = labels.reshape(-1)
    d = data.reshape(data.shape[0], -1)
    keep = (lab >= 0) & (lab < num_labels)
    idx = lab[keep].to(torch.int64)
    d = d[:, keep].to(torch.int64)
    rows = torch.cat([torch.ones_like(d[:1]), d, d * d], dim=0)
    acc = torch.zeros((rows.shape[0], num_labels), dtype=torch.int64, device=labels.device)
    return acc.index_add_(1, idx, rows).to(fdt)


def table_gather(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """out[..., p] = table[..., labels[p]], zeros for labels outside [0, L)."""
    idx = labels.reshape(-1).to(torch.int64)
    num = table.shape[-1]
    inb = (idx >= 0) & (idx < num)
    out = table[..., idx.clamp(0, num - 1)].masked_fill(~inb, 0)
    return out.reshape(*table.shape[:-1], *labels.shape)


# (dx, dy) in the reference's insertion order: x outer, y inner.
OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
DIRECT = {(-1, 0), (1, 0), (0, -1), (0, 1)}


def _shift(x, dy, dx, fill):
    h, w = x.shape[-2:]
    py, px = abs(dy), abs(dx)
    xp = torch.nn.functional.pad(x, (px, px, py, py), value=fill)
    return xp[..., py + dy: py + dy + h, px + dx: px + dx + w]


def _shift_edge(x, dy, dx):
    h, w = x.shape[-2:]
    rows = (torch.arange(h, device=x.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=x.device) + dx).clamp(0, w - 1)
    return x[:, rows][:, :, cols]


def feature_costs(img, features, c_total):
    """Per-feature cost planes of a stat image [1 + 2C, ...]; features are
    (kind, offset, channels, weight).  Gaussian: sum over channels of
    n/2 log(2 pi var) + n/2 (var floored at 1/12), over C; compactness: sum
    of sumsq - sum^2/n.  Divisions divide by tensors, in the program's
    order."""
    dev, fdt = img.device, img.dtype

    def const(value):  # a fill on the device: no host copy, so it can be captured
        return torch.full((), value, dtype=fdt, device=dev)

    one, var_floor, two_pi = const(1.0), const(1.0 / 12.0), const(2.0 * math.pi)
    n = img[0]
    n_safe = torch.maximum(n, one)
    out = []
    for kind, offset, channels, _ in features:
        acc = None
        for c in range(channels):
            s = img[1 + offset + c]
            ss = img[1 + c_total + offset + c]
            if kind == "gaussian":
                q = s / n_safe
                var = torch.maximum(ss / n_safe - q * q, var_floor)
                half = n / 2.0
                t = half * torch.log(two_pi * var) + half
            else:
                t = ss - (s * s) / n_safe
            acc = t if acc is None else acc + t
        if kind == "gaussian":
            acc = acc / const(float(channels))
        out.append(torch.where(n > 0, acc, 0.0))
    return out


def relax_sweep(labels, stat_img, pixel_rows, features, c_total, direct_cost, diagonal_cost):
    """One synchronous sweep: every boundary pixel takes the candidate
    label (itself or a neighbour's) of least energy -> (labels, stat image)."""
    h, w = labels.shape
    dev = labels.device
    nbs = [_shift(labels, dy, dx, OOB) for (dx, dy) in OFFSETS]
    boundary = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for (dx, dy), nb in zip(OFFSETS, nbs):
        if (dx, dy) != (0, 0):
            boundary = boundary | ((nb != OOB) & (nb != labels))
    active = boundary & (labels != OOB)

    cost_img = feature_costs(stat_img, features, c_total)
    old_minus = feature_costs(stat_img - pixel_rows, features, c_total)
    best_cost = torch.full((h, w), math.inf, dtype=stat_img.dtype, device=dev)
    best_label = labels
    upd = stat_img
    for (dx, dy), cand in zip(OFFSETS, nbs):
        cand_valid = cand != OOB
        cand_c = torch.where(cand_valid, cand, 0)
        cand_img = _shift_edge(stat_img, dy, dx)
        cand_cost = [_shift(ci, dy, dx, 0.0) for ci in cost_img]
        clique = torch.zeros((h, w), dtype=stat_img.dtype, device=dev)
        for (dx2, dy2), nb2 in zip(OFFSETS, nbs):
            if (dx2, dy2) == (0, 0):
                continue
            cc = direct_cost if (dx2, dy2) in DIRECT else diagonal_cost
            clique = clique + torch.where((nb2 != OOB) & (nb2 != cand_c), cc, 0.0).to(
                stat_img.dtype)
        cand_plus = feature_costs(cand_img + pixel_rows, features, c_total)
        total = clique
        is_old = cand_c == labels
        for i, (_, _, _, weight) in enumerate(features):
            delta = old_minus[i] + cand_plus[i] - cost_img[i] - cand_cost[i]
            total = total + weight * torch.where(is_old, 0.0, delta)
        total = torch.where(cand_valid, total, math.inf)
        take = total < best_cost
        best_cost = torch.where(take, total, best_cost)
        best_label = torch.where(take, cand_c, best_label)
        upd = torch.where(take[None], cand_img, upd)
    new_labels = torch.where(active, best_label, labels)
    return new_labels, torch.where(active[None], upd, stat_img)


def relax_start(labels, data_all, num_labels):
    """What a relax call's sweeps start from: the per-pixel stat image of
    the call's one statistics table (the 'frame' statistics mode: the table
    of the incoming labels), and the pixels' own rows [1, d, d^2]."""
    table = moment_table(labels, data_all.to(torch.int32), num_labels, data_all.dtype)
    stat_img = table_gather(table, labels).contiguous()
    pixel_rows = torch.cat([torch.ones_like(data_all[:1]), data_all, data_all * data_all])
    return stat_img, pixel_rows


# ---------------------------------------------------------- plane votes

def classify(derivative: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """Vertical derivative -> uint8 classes; ranges int32 [[h0, h1], [v0, v1]],
    half-open, the horizontal range first."""
    d = derivative.to(torch.int32)
    valid = d != DERIVATIVE_INVALID
    is_h = valid & (d >= ranges[0, 0]) & (d < ranges[0, 1])
    is_v = valid & (d >= ranges[1, 0]) & (d < ranges[1, 1]) & ~is_h
    return torch.where(is_h, HORIZONTAL, torch.where(is_v, VERTICAL, UNKNOWN)).to(torch.uint8)


def _vote(votes, compare_unknown: bool) -> torch.Tensor:
    winner = torch.where(votes[HORIZONTAL] > votes[VERTICAL], HORIZONTAL, VERTICAL)
    wv = torch.where(winner == HORIZONTAL, votes[HORIZONTAL], votes[VERTICAL])
    unknown = wv < votes[UNKNOWN] if compare_unknown else wv == 0
    return torch.where(unknown, UNKNOWN, winner).to(torch.uint8)


def temporal_vote_warped(current, prev_planes, warp_state, flow, current_weight: int,
                         compare_unknown: bool):
    """The carried vote: V_k(t) = warp_{f_t}(V_{k-1}(t-1)), V_0 := planes(t-1),
    warped by the integer part of the flow ('gather': unbounded, off-frame
    sources give no vote) -> (voted uint8 [H, W], new state uint8 [K, H, W])."""
    k, h, w = warp_state.shape
    dev = current.device
    stack_in = torch.cat([prev_planes[None], warp_state[:-1]], dim=0).to(torch.int32)
    packed = torch.zeros((h, w), dtype=torch.int32, device=dev)
    all_invalid = 0
    for c in range(k):
        packed = packed | (stack_in[c] << (2 * c))
        all_invalid |= WARP_INVALID << (2 * c)
    fx = flow[..., 0].to(torch.int32) >> 5
    fy = flow[..., 1].to(torch.int32) >> 5
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None] - fy
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :] - fx
    inb = (xs >= 0) & (ys >= 0) & (xs < w) & (ys < h)
    idx = ys.clamp(0, h - 1).to(torch.int64) * w + xs.clamp(0, w - 1)
    warped = torch.where(inb, packed.reshape(-1)[idx], all_invalid)
    new_state = torch.stack([((warped >> (2 * c)) & 3).to(torch.uint8) for c in range(k)])
    votes = [(new_state == plane).sum(dim=0, dtype=torch.int32)
             + torch.where(current == plane, current_weight, 0)
             for plane in range(PLANE_COUNT)]
    return _vote(votes, compare_unknown), new_state


def superpixel_vote(pixel_planes: torch.Tensor, labels: torch.Tensor, num_labels: int):
    """Per-label class counts, the winner per label (UNKNOWN, then VERTICAL
    on strictly more votes, then HORIZONTAL on strictly more), painted back.
    Pixels whose label is outside [0, L) or whose class is not a plane add
    nothing (they add a weight of 0, which needs no read back)."""
    lab = labels.reshape(-1).to(torch.int64)
    v = pixel_planes.reshape(-1).to(torch.int64)
    keep = (lab >= 0) & (lab < num_labels) & (v < PLANE_COUNT)
    idx = (lab * PLANE_COUNT + v).clamp(0, num_labels * PLANE_COUNT - 1)
    counts = torch.zeros(num_labels * PLANE_COUNT, dtype=torch.int64, device=labels.device)
    counts = counts.index_add_(0, idx, keep.to(torch.int64)).view(num_labels, PLANE_COUNT)
    best = torch.full((num_labels,), UNKNOWN, dtype=torch.int64, device=labels.device)
    best_votes = counts[:, UNKNOWN]
    take_v = counts[:, VERTICAL] > best_votes
    best = torch.where(take_v, VERTICAL, best)
    best_votes = torch.where(take_v, counts[:, VERTICAL], best_votes)
    best = torch.where(counts[:, HORIZONTAL] > best_votes, HORIZONTAL, best)
    return table_gather(best, labels).to(torch.uint8)
