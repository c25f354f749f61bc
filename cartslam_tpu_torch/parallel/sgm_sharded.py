"""Exact height-sharded SGM (counterpart of cartslam_tpu/parallel/
sgm_sharded.py): bit-equal to the full-frame op for any shard count.

The SGM vertical recurrence is min-plus linear in its carry, so a sweep
seeded with the TRUE final carry of the predecessor shard is an exact
continuation of the full-frame scan.  Shard 0's top-down sweep is exact by
construction; a chain of n-1 ``ppermute`` hops of the [W, D] carry then
makes each following shard exact in turn, and symmetrically bottom-up.

The census sees true neighbour rows through a 3-row halo; the cost volume,
horizontal sweeps, WTA, uniqueness and LR check are row-local.  On CUDA
tensors the shard's SGM is kernel K5: the settle sweeps of
kernels/sgm.sgm_vcarry inside `settled_carries` below, then the output pass
kernels/sgm.sgm_fused_sharded; on CPU tensors both wrappers take their plain
versions, built on ops/stereo._aggregate_scan with an explicit carry.
"""

from __future__ import annotations

import torch

from ..kernels import sgm as ksgm
from ..ops import stereo

_CENSUS_HALO = stereo.CENSUS_HT // 2  # 3 rows for the 9x7 window


def chain_perms(n: int) -> tuple[list, list]:
    """(top-down, bottom-up) carry hand-offs: shard i to i+1, and i to i-1."""
    return [(i, i + 1) for i in range(n - 1)], [(i, i - 1) for i in range(1, n)]


def settled_carries(settle, sp):
    """The split-scan chain of both vertical directions at once: n-1 rounds
    of ``settle(tb, bt) -> (tb_fin, bt_fin)`` (the shard's final carries
    from its carries in; None is a zero carry), each followed by the
    top-down hand-off i -> i+1 and the bottom-up one i -> i-1.  Returns the
    settled (tb, bt) carries of the calling shard, None at the edges.

    Invariant: after j hops, shards 0..j (resp. n-1-j..n-1) hold their exact
    predecessor carry; n-1 hops settle all of them."""
    n, idx = sp.n, sp.index
    fwd, bwd = chain_perms(n)
    tb = bt = None
    for _ in range(n - 1):
        tb_fin, bt_fin = settle(tb, bt)
        tb_recv = sp.group.ppermute(tb_fin, fwd)
        bt_recv = sp.group.ppermute(bt_fin, bwd)
        tb = None if idx == 0 else tb_recv
        bt = None if idx == n - 1 else bt_recv
    return tb, bt


def sgm_census_sharded(cl0, cl1, cr0, cr1, sp, *, plain: bool = False,
                       **kw) -> torch.Tensor:
    """K5 on one row shard's census words (int32 [h, W] x2 per view) ->
    int16 x16 disparity [h, W], bit-equal to the full frame's rows: the
    carries settled across the group through kernels/sgm.sgm_vcarry, then
    the output pass kernels/sgm.sgm_fused_sharded.  `plain` takes both
    steps' plain versions (on any device); on CPU tensors the kernels'
    wrappers take them anyway.  Every shard of the group calls this
    together (the carry hand-offs are collectives)."""
    ckw = {k: kw[k] for k in ("min_disparity", "num_disparities", "p1", "p2")}
    vcarry = ksgm.sgm_vcarry_plain if plain else ksgm.sgm_vcarry
    fused = ksgm.sgm_fused_sharded_plain if plain else ksgm.sgm_fused_sharded
    tb, bt = settled_carries(lambda tb, bt: vcarry(cl0, cl1, cr0, cr1, tb, bt, **ckw), sp)
    return fused(cl0, cl1, cr0, cr1, tb, bt, **kw)


def sgm_disparity_sharded(gray_l: torch.Tensor, gray_r: torch.Tensor, sp, *,
                          min_disparity: int = 4, num_disparities: int = 256, p1: int = 10,
                          p2: int = 120, uniqueness: int = 12, lr_check: bool = True,
                          subpixel: bool = True) -> torch.Tensor:
    """`stereo.sgm_disparity` on a row shard [h_local, W] of the shard
    group behind `sp` (a SpatialContext), bit-equal to the full frame."""
    stereo.check_sgm_params(p1, p2)
    hc = _CENSUS_HALO
    gl = sp.exchange(gray_l, hc, hc)
    gr = sp.exchange(gray_r, hc, hc)
    cl0, cl1 = (c[hc:-hc].contiguous() for c in stereo.census_transform(gl))
    cr0, cr1 = (c[hc:-hc].contiguous() for c in stereo.census_transform(gr))
    return sgm_census_sharded(
        cl0, cl1, cr0, cr1, sp, min_disparity=min_disparity,
        num_disparities=num_disparities, p1=p1, p2=p2, uniqueness=uniqueness,
        subpixel=subpixel, lr_check=lr_check,
    )
