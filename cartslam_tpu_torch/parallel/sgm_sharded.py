"""Exact height-sharded SGM (counterpart of cartslam_tpu/parallel/
sgm_sharded.py): bit-equal to the full-frame op for any shard count.

The SGM vertical recurrence is min-plus linear in its carry, so a sweep
seeded with the TRUE final carry of the predecessor shard is an exact
continuation of the full-frame scan.  Shard 0's top-down sweep is exact by
construction; a chain of n-1 ``ppermute`` hops of the [W, D] carry then
makes each following shard exact in turn, and symmetrically bottom-up.  In
each hop only the shard whose carry in is already exact sweeps.

The census (kernels/census: both images in one launch on CUDA tensors) sees
true neighbour rows through a 3-row halo; the cost volume,
horizontal sweeps, WTA, uniqueness and LR check are row-local.  On CUDA
tensors the shard's SGM is kernel K5: the output pass
kernels/sgm.sgm_fused_sharded (its row paths on a side stream before the
chain, its column paths and WTA after it) around the settle sweeps of
kernels/sgm.sgm_vcarry inside `settled_carries` below; on CPU tensors both
wrappers take their plain versions, built on ops/stereo._aggregate_scan
with an explicit carry.
"""

from __future__ import annotations

import torch

from ..kernels import census as kcensus
from ..kernels import sgm as ksgm
from ..ops import stereo

_CENSUS_HALO = stereo.CENSUS_HT // 2  # 3 rows for the 9x7 window


def chain_perms(n: int) -> tuple[list, list]:
    """(top-down, bottom-up) carry hand-offs: shard i to i+1, and i to i-1."""
    return [(i, i + 1) for i in range(n - 1)], [(i, i - 1) for i in range(1, n)]


def settled_carries(settle, sp, on_settled=None):
    """The split-scan chain of both vertical directions, exact sweeps only:
    n-1 rounds.  In round j shard j sweeps top-down and shard n-1-j
    bottom-up (at odd n the middle shard sweeps both in one call), through
    ``settle(tb, bt, top_down, bottom_up) -> (tb_fin, bt_fin)`` (the
    shard's final carries from its carries in; None is a zero carry in,
    and a direction not swept gives None); no other shard sweeps.  Every
    shard then takes part in the round's hand-offs, top-down i -> i+1 and
    bottom-up i -> i-1, both in one collective, where a shard that did not
    sweep hands on nothing.  Returns the settled (tb, bt) carries of the
    calling shard, None at the edges; `on_settled(tb, bt)`, when given, is
    called with them once, as soon as they are settled (after the round
    in which the last of them arrives, while the chain goes on), and the
    chain then ends with a barrier: no shard returns before every shard's
    on_settled has run.

    Invariant: shard j's top-down carry is exact from round j-1 on (shard
    0's, a zero carry, from the start), so its sweep in round j is exact
    and hands on shard j+1's; symmetrically bottom-up.  A shard keeps the
    top-down carry it receives in round i-1 and the bottom-up one of round
    n-2-i, and never overwrites them: 2(n-1) direction-sweeps settle all
    shards, where sweeping every shard every round took n-1 times more."""
    n, idx = sp.n, sp.index
    fwd, bwd = chain_perms(n)
    settled_at = max(idx - 1, n - 2 - idx)  # the round of the last carry in
    tb = bt = None
    if on_settled is not None and settled_at < 0:
        on_settled(tb, bt)
    for j in range(n - 1):
        down, up = idx == j, idx == n - 1 - j
        tb_fin, bt_fin = settle(tb, bt, down, up) if down or up else (None, None)
        tb_recv, bt_recv = sp.group.ppermutes((tb_fin, fwd), (bt_fin, bwd))
        if idx == j + 1:
            tb = tb_recv
        if idx == n - 2 - j:
            bt = bt_recv
        if on_settled is not None and j == settled_at:
            on_settled(tb, bt)
    if on_settled is not None:
        sp.group.barrier()
    return tb, bt


def sgm_census_sharded(cl0, cl1, cr0, cr1, sp, *, plain: bool = False,
                       **kw) -> torch.Tensor:
    """K5 on one row shard's census words (int32 [h, W] x2 per view) ->
    int16 x16 disparity [h, W], bit-equal to the full frame's rows: the
    output pass kernels/sgm.sgm_fused_sharded around the carries settled
    across the group through kernels/sgm.sgm_vcarry.  `plain` takes both
    steps' plain versions (on any device); on CPU tensors the kernels'
    wrappers take them anyway.  Every shard of the group calls this
    together (the carry hand-offs are collectives)."""
    ckw = {k: kw[k] for k in ("min_disparity", "num_disparities", "p1", "p2")}
    vcarry = ksgm.sgm_vcarry_plain if plain else ksgm.sgm_vcarry
    carries = lambda on_settled=None: settled_carries(
        lambda tb, bt, down, up: vcarry(cl0, cl1, cr0, cr1, tb, bt, top_down=down,
                                        bottom_up=up, **ckw), sp, on_settled)
    if plain:
        return ksgm.sgm_fused_sharded_plain(cl0, cl1, cr0, cr1, *carries(), **kw)
    return ksgm.sgm_fused_sharded(cl0, cl1, cr0, cr1, carries, side=sp.group.side_stream(),
                                  **kw)


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
    cl0, cl1, cr0, cr1 = (c[hc:-hc].contiguous() for words in kcensus.census_pair(gl, gr)
                          for c in words)
    return sgm_census_sharded(
        cl0, cl1, cr0, cr1, sp, min_disparity=min_disparity,
        num_disparities=num_disparities, p1=p1, p2=p2, uniqueness=uniqueness,
        subpixel=subpixel, lr_check=lr_check,
    )
