"""Census + semi-global matching (counterpart of cartslam_tpu/ops/stereo.py).

Output contract: int16 disparity in x16 fixed point, invalid = -32768.

The census transform here is plain tensor code: the plain version of the
census kernel (kernels/census.py, csrc/census.cu).  The rest of this file is
the plain SGM chain (cost volume, 4-path aggregation, winner-take-all with
uniqueness and subpixel, left-right check) in the XLA path's formulation:
it is the plain version of the fused CUDA kernel K1
(kernels/sgm.py, csrc/sgm.cu), which replaces the Pallas
``sgm_fused_pallas`` on the device.
"""

from __future__ import annotations

import torch

DISPARITY_INVALID = -32768

CENSUS_WH = 9  # window width
CENSUS_HT = 7  # window height

# Cost of an out-of-range candidate (max hamming distance of a 62-bit census).
COST_INVALID = 62
# int16 sentinel of the aggregated volume (fill past the image edge).
_BIG16 = 32767


def pad_edge(x: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """Edge-replicate padding of the last two dims (any dtype)."""
    h, w = x.shape[-2:]
    rows = torch.arange(-py, h + py, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-px, w + px, device=x.device).clamp(0, w - 1)
    return x[..., rows, :][..., cols]


def census_transform(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """9x7 census -> two int32 words [H, W]; bit k set when the k-th
    neighbor (row-major, center skipped) is strictly greater than the
    center."""
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
            nb = padded[dy + ph : dy + ph + h, dx + pw : dx + pw + w]
            b = (nb > g).to(torch.int32)
            word = bit // 31
            words[word] = words[word] | (b << (bit % 31))
            bit += 1
    return words[0], words[1]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative int32 values (torch has no popcount op)."""
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_cost_volume(left_census, right_census, min_disparity: int,
                        num_disparities: int) -> torch.Tensor:
    """Cost volume [D, H, W] uint8: hamming(censusL[x], censusR[x-d]);
    candidates reading outside the right image cost COST_INVALID."""
    l0, l1 = left_census
    r0, r1 = right_census
    h, w = l0.shape
    max_d = min_disparity + num_disparities
    r0p = torch.nn.functional.pad(r0, (max_d, 0))
    r1p = torch.nn.functional.pad(r1, (max_d, 0))
    cols = torch.arange(w, device=l0.device)[None, :]
    out = []
    for i in range(num_disparities):
        d = min_disparity + i
        rd0 = r0p[:, max_d - d : max_d - d + w]
        rd1 = r1p[:, max_d - d : max_d - d + w]
        c = popcount32(l0 ^ rd0) + popcount32(l1 ^ rd1)
        c = torch.where(cols >= d, c, COST_INVALID)
        out.append(c.to(torch.uint8))
    return torch.stack(out, dim=0)


def _aggregate_scan(cost_srd: torch.Tensor, p1: int, p2: int,
                    carry: torch.Tensor | None = None) -> torch.Tensor:
    """Path recurrence along axis 0 of [S, R, D], from `carry` (int32
    [R, D]; None is a zero carry), returning every step's int32 values:

    L(p,d) = C(p,d) + min(L(p-1,d), L(p-1,d+-1)+P1, min_d' L(p-1,d')+P2)
           - min_d' L(p-1,d')

    With the true final carry of a preceding segment, the scan continues
    that segment's recurrence exactly (the height-sharded SGM's split scan).
    """
    big = torch.full_like(cost_srd[0, :, :1], 1 << 20, dtype=torch.int32)
    if carry is None:
        carry = torch.zeros_like(cost_srd[0], dtype=torch.int32)
    out = torch.empty_like(cost_srd, dtype=torch.int32)
    for s in range(cost_srd.shape[0]):
        m = carry.min(dim=-1, keepdim=True).values
        dn = torch.cat([big, carry[:, :-1]], dim=-1)
        up = torch.cat([carry[:, 1:], big], dim=-1)
        best = torch.minimum(torch.minimum(carry, torch.minimum(dn, up) + p1), m + p2)
        carry = cost_srd[s].to(torch.int32) + best - m
        out[s] = carry
    return out


def sgm_aggregate(cost_dhw: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """Sum of the 4 directional path aggregations -> [H, W, D] int32."""
    chwd = cost_dhw.permute(1, 2, 0)  # [H, W, D]
    cw = chwd.permute(1, 0, 2)  # [W, H, D]
    lr = _aggregate_scan(cw, p1, p2)
    rl = _aggregate_scan(cw.flip(0), p1, p2).flip(0)
    s = (lr + rl).permute(1, 0, 2)
    tb = _aggregate_scan(chwd, p1, p2)
    bt = _aggregate_scan(chwd.flip(0), p1, p2).flip(0)
    return s + tb + bt


def _wta(s_hwd: torch.Tensor, min_disparity: int, uniqueness: int, subpixel: bool):
    """Winner-take-all (lowest-d tie-break), OpenCV uniqueness test and
    quadratic subpixel fit in 1/16 px.  Returns (disp16, best, unique_ok)."""
    d = s_hwd.shape[-1]
    dt = torch.arange(d, device=s_hwd.device)
    key = s_hwd * d + dt
    min_key = key.min(dim=-1).values
    best = torch.remainder(min_key, d)
    min_s = torch.div(min_key, d, rounding_mode="floor")

    near = (dt - best[..., None]).abs() <= 1
    second = torch.where(near, _BIG16, s_hwd).min(dim=-1).values
    unique_ok = second * (100 - uniqueness) >= min_s * 100

    if subpixel:
        sm = torch.gather(s_hwd, -1, (best - 1).clamp(min=0)[..., None])[..., 0]
        sp = torch.gather(s_hwd, -1, (best + 1).clamp(max=d - 1)[..., None])[..., 0]
        denom2 = torch.clamp(sm + sp - 2 * min_s, min=1)
        delta = torch.div((sm - sp) * 16 + denom2, denom2 * 2, rounding_mode="floor")
        delta = torch.where((best > 0) & (best < d - 1), delta, 0)
    else:
        delta = torch.zeros_like(best)
    return (best + min_disparity) * 16 + delta, best, unique_ok


def _lr_agreement(s_hwd: torch.Tensor, best: torch.Tensor, min_disparity: int):
    """Left-right check from one aggregated volume.

    Right-view WTA: S_right[x, d] = S[x + d + minD, d] (32767 past the
    edge); left pixel x with winner d is kept iff the right pixel
    xr = x - d - minD exists and |best_r[xr] - d| <= 1.
    """
    h, w, d = s_hwd.shape
    dt = torch.arange(d, device=s_hwd.device)
    cols = torch.arange(w, device=s_hwd.device)
    src = cols[:, None] + dt[None, :] + min_disparity  # [W, D]
    inb = src < w
    idx = src.clamp(max=w - 1)[None].expand(h, w, d)
    sheared = torch.where(inb[None], torch.gather(s_hwd, 1, idx), _BIG16)
    best_r = torch.remainder((sheared * d + dt).min(dim=-1).values, d)
    xr = cols[None, :] - best - min_disparity
    br = torch.gather(best_r, 1, xr.clamp(min=0))
    return (xr >= 0) & ((br - best).abs() <= 1)


def sgm_from_census_plain(cl0, cl1, cr0, cr1, *, min_disparity: int,
                          num_disparities: int, p1: int, p2: int,
                          uniqueness: int, subpixel: bool,
                          lr_check: bool) -> torch.Tensor:
    """Census pair -> int16 x16 disparity: the plain version of kernel K1."""
    h, w = cl0.shape
    cost = hamming_cost_volume((cl0, cl1), (cr0, cr1), min_disparity, num_disparities)
    s = sgm_aggregate(cost, p1, p2)
    disp16, best, valid = _wta(s, min_disparity, uniqueness, subpixel)
    cols = torch.arange(w, device=cl0.device)[None, :]
    valid = valid & (cols >= best + min_disparity)
    if lr_check:
        valid = valid & _lr_agreement(s, best, min_disparity)
    return torch.where(valid, disp16, DISPARITY_INVALID).to(torch.int16)


def check_sgm_params(p1: int, p2: int) -> None:
    """The reference's parameter limits (ops/stereo.py:sgm_disparity)."""
    if p2 > 8000:
        raise ValueError(
            f"p2={p2} breaks the int16 aggregated-volume contract "
            "(4 * (62 + p2) must stay below 32767); use p2 <= 8000"
        )
    if p1 < 0 or p2 < p1:
        raise ValueError(f"need 0 <= p1 <= p2, got p1={p1}, p2={p2}")


def sgm_disparity(left_gray: torch.Tensor, right_gray: torch.Tensor, *,
                  min_disparity: int = 4, num_disparities: int = 256,
                  p1: int = 10, p2: int = 120, uniqueness: int = 12,
                  lr_check: bool = True, subpixel: bool = True) -> torch.Tensor:
    """Gray uint8 pair -> int16 x16 disparity (-32768 = invalid).

    The census of both images (one launch) and the aggregation and WTA
    (kernel K1) run as kernels on CUDA tensors and as their plain versions
    on CPU tensors.
    """
    from ..kernels import census as kcensus
    from ..kernels import sgm as ksgm

    check_sgm_params(p1, p2)
    (cl0, cl1), (cr0, cr1) = kcensus.census_pair(left_gray, right_gray)
    return ksgm.sgm_fused(
        cl0, cl1, cr0, cr1, min_disparity=min_disparity,
        num_disparities=num_disparities, p1=p1, p2=p2,
        uniqueness=uniqueness, subpixel=subpixel, lr_check=lr_check,
    )
