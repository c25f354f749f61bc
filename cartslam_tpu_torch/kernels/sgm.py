"""Kernels K1 (fused SGM), K5 (K1 on a row shard, with carries handed
between shards) and K6 (4-path aggregated volume), csrc/sgm.cu, with their
plain versions.

K1 replaces the Pallas ``sgm_fused_pallas`` (cartslam_tpu/ops/pallas/
sgm.py:654, with ``wta_lr_row`` of ops/pallas/wta.py:66); K5 replaces
``sgm_fused_pallas_sharded`` (ops/pallas/sgm.py:320); K6 replaces
``sgm_aggregate_pallas`` (ops/pallas/sgm.py:510).  On a CUDA tensor a wrapper
launches its CUDA kernels or raises; on a CPU tensor it runs the plain
version, the XLA path's chain in ops/stereo.py.  K5's wrappers work on one
row shard: the settle sweep from given carries, and the output pass around
a settle chain it is handed; the split-scan chain that settles the carries
across shards is parallel/sgm_sharded.py's.
"""

from __future__ import annotations

import torch

from ..ops import stereo
from . import build

COUNTER = build.counter("sgm")
SHARDED_COUNTER = build.counter("sgm_sharded")
SETTLE_COUNTER = build.counter("sgm_settle")
AGGREGATE_COUNTER = build.counter("sgm_aggregate")
# Path values are stored as uint8: each is bounded by COST_INVALID + p2.
MAX_P2 = 255 - stereo.COST_INVALID
MAX_DISPARITIES = 256


def padded_disparities(num_disparities: int) -> int:
    """The d stride of the kernels' path volumes: D rounded up to 16, so
    that the WTA kernel reads 16 disparities with one 16-byte load."""
    return (num_disparities + 15) // 16 * 16


def _path_volume(h: int, w: int, num_disparities: int, dtype, device) -> torch.Tensor:
    """Scratch for K1's and K5's four path volumes [4, h, w, Dp]."""
    return torch.empty((4, h, w, padded_disparities(num_disparities)), dtype=dtype,
                       device=device)


def _check_census(cl0, cl1, cr0, cr1) -> tuple[int, int]:
    h, w = cl0.shape
    for name, t in (("cl0", cl0), ("cl1", cl1), ("cr0", cr0), ("cr1", cr1)):
        build.expect(t, name, torch.int32, (h, w), cl0.device)
    return h, w


@build.on_its_card
def sgm_fused(cl0, cl1, cr0, cr1, *, min_disparity: int, num_disparities: int,
              p1: int, p2: int, uniqueness: int, subpixel: bool,
              lr_check: bool) -> torch.Tensor:
    """Census words (int32 [H, W] x2 per view) -> int16 x16 disparity."""
    kw = dict(min_disparity=min_disparity, num_disparities=num_disparities,
              p1=p1, p2=p2, uniqueness=uniqueness, subpixel=subpixel,
              lr_check=lr_check)
    if cl0.device.type == "cpu":
        COUNTER.plain_calls += 1
        return stereo.sgm_from_census_plain(cl0, cl1, cr0, cr1, **kw)
    _check_k1_params(p2, num_disparities, min_disparity)
    h, w = _check_census(cl0, cl1, cr0, cr1)
    lib = build.library()
    vol = _path_volume(h, w, num_disparities, torch.uint8, cl0.device)
    out = torch.empty((h, w), dtype=torch.int16, device=cl0.device)
    s = build.stream()
    build.check(lib.sgm_paths(cl0.data_ptr(), cl1.data_ptr(), cr0.data_ptr(),
                              cr1.data_ptr(), vol.data_ptr(), h, w,
                              num_disparities, min_disparity, p1, p2, s),
                "sgm_paths")
    build.check(lib.sgm_wta(vol.data_ptr(), out.data_ptr(), h, w, num_disparities,
                            min_disparity, uniqueness, int(subpixel),
                            int(lr_check), s),
                "sgm_wta")
    COUNTER.launches += 1
    return out


def _check_k1_params(p2: int, num_disparities: int, min_disparity: int = 0) -> None:
    if p2 > MAX_P2:
        raise ValueError(f"sgm kernel stores path values as uint8: needs p2 <= {MAX_P2}")
    _check_range(num_disparities, min_disparity)


def _check_range(num_disparities: int, min_disparity: int) -> None:
    if not 1 <= num_disparities <= MAX_DISPARITIES:
        raise ValueError(f"sgm kernel takes 1..{MAX_DISPARITIES} disparities")
    if min_disparity < 0:
        raise ValueError("sgm kernel takes min_disparity >= 0")


def sgm_vcarry_plain(cl0, cl1, cr0, cr1, tb, bt, *, min_disparity: int,
                     num_disparities: int, p1: int, p2: int, top_down: bool = True,
                     bottom_up: bool = True):
    """One settle sweep, plain: the final carries int32 [W, D] of the
    shard's top-down sweep from carry tb and of its bottom-up sweep from bt
    (None is a zero carry), for the directions asked for; a direction not
    swept gives None."""
    cost = stereo.hamming_cost_volume((cl0, cl1), (cr0, cr1), min_disparity, num_disparities)
    chwd = cost.permute(1, 2, 0)
    return (stereo._aggregate_scan(chwd, p1, p2, tb)[-1] if top_down else None,
            stereo._aggregate_scan(chwd.flip(0), p1, p2, bt)[-1] if bottom_up else None)


@build.on_its_card
def sgm_vcarry(cl0, cl1, cr0, cr1, tb, bt, *, min_disparity: int, num_disparities: int,
               p1: int, p2: int, top_down: bool = True, bottom_up: bool = True):
    """One settle sweep of K5 (sgm_vcarry in csrc/sgm.cu): the vertical
    sweep(s) of one row shard asked for, top-down from carry tb and
    bottom-up from bt (None is a zero carry), in one launch that writes no
    volume, only the final carries; a direction not swept gives None.  A
    step of K5 (see parallel/sgm_sharded.py), counted by `sgm_settle`."""
    if not (top_down or bottom_up):
        raise ValueError("sgm_vcarry: no direction to sweep")
    ckw = dict(min_disparity=min_disparity, num_disparities=num_disparities, p1=p1, p2=p2,
               top_down=top_down, bottom_up=bottom_up)
    if cl0.device.type == "cpu":
        SETTLE_COUNTER.plain_calls += 1
        return sgm_vcarry_plain(cl0, cl1, cr0, cr1, tb, bt, **ckw)
    _check_k1_params(p2, num_disparities, min_disparity)
    h, w = _check_census(cl0, cl1, cr0, cr1)
    tb, bt = (tb if top_down else None), (bt if bottom_up else None)
    _check_carries(tb, bt, w, num_disparities, cl0.device)
    new = lambda on: (torch.empty((w, num_disparities), dtype=torch.int32, device=cl0.device)
                      if on else None)
    tb_fin, bt_fin = new(top_down), new(bottom_up)
    build.check(build.library().sgm_vcarry(
        cl0.data_ptr(), cl1.data_ptr(), cr0.data_ptr(), cr1.data_ptr(), build.ptr(tb),
        build.ptr(bt), build.ptr(tb_fin), build.ptr(bt_fin), h, w, num_disparities,
        min_disparity, p1, p2, build.stream()), "sgm_vcarry")
    SETTLE_COUNTER.launches += 1
    return tb_fin, bt_fin


def _check_carries(tb, bt, w: int, num_disparities: int, device) -> None:
    for name, t in (("tb", tb), ("bt", bt)):
        if t is not None:
            build.expect(t, name, torch.int32, (w, num_disparities), device)


def sgm_fused_sharded_plain(cl0, cl1, cr0, cr1, tb, bt, *, min_disparity: int,
                            num_disparities: int, p1: int, p2: int, uniqueness: int,
                            subpixel: bool, lr_check: bool) -> torch.Tensor:
    """The plain version of K5's output pass: the cost volume and horizontal
    paths of the shard, the vertical paths seeded with the settled carries
    tb and bt (None is a zero carry), then WTA and LR."""
    h, w = cl0.shape
    cost = stereo.hamming_cost_volume((cl0, cl1), (cr0, cr1), min_disparity, num_disparities)
    chwd = cost.permute(1, 2, 0)  # [h, W, D]
    cw = chwd.permute(1, 0, 2)  # [W, h, D]
    s = (stereo._aggregate_scan(cw, p1, p2)
         + stereo._aggregate_scan(cw.flip(0), p1, p2).flip(0)).permute(1, 0, 2)
    s = s + stereo._aggregate_scan(chwd, p1, p2, tb)
    s = s + stereo._aggregate_scan(chwd.flip(0), p1, p2, bt).flip(0)
    disp16, best, valid = stereo._wta(s, min_disparity, uniqueness, subpixel)
    cols = torch.arange(w, device=cl0.device)[None, :]
    valid = valid & (cols >= best + min_disparity)
    if lr_check:
        valid = valid & stereo._lr_agreement(s, best, min_disparity)
    return torch.where(valid, disp16, stereo.DISPARITY_INVALID).to(torch.int16)


@build.on_its_card
def sgm_fused_sharded(cl0, cl1, cr0, cr1, carries, *, side: torch.cuda.Stream | None,
                      min_disparity: int, num_disparities: int, p1: int, p2: int,
                      uniqueness: int, subpixel: bool, lr_check: bool) -> torch.Tensor:
    """K5's output pass on one row shard around its settle chain: census
    words (int32 [h, W] x2 per view) -> int16 x16 disparity [h, W], the
    counterpart of sgm_fused_pallas_sharded's output sweeps and WTA.
    `carries(on_settled=None)` runs the shard's part of the settle chain on
    the current stream and returns the settled vertical carries (tb, bt:
    int32 [W, D]; None is a zero carry), calling on_settled(tb, bt) as soon
    as they are settled; with parallel/sgm_sharded.settled_carries the
    output equals the full frame's rows.

    On the card the pass forks onto `side`, a CUDA stream of the shard's
    own (parallel/group.ShardGroup.side_stream; None on the CPU): the row
    paths, which need no carry, are launched there before the
    chain, so that they run beside it and beside the other shards' row
    paths.  As soon as the carries are settled, the side stream waits for
    the current stream (the sweeps that made them) and runs the seeded
    column paths and the WTA, while the chain goes on; when the chain
    returns, the current stream waits for the side stream, so the call
    returns with the fork joined.  The chain returns on no shard before
    every shard has forked (settled_carries ends with a barrier): a fork
    made after another shard's join on the one current stream would wait
    for that shard's output pass, and the output passes would run one
    after another.  The volume is allocated on the side stream, which
    alone uses it; every other tensor the side stream reads or writes
    outlives the join."""
    kw = dict(min_disparity=min_disparity, num_disparities=num_disparities,
              p1=p1, p2=p2, uniqueness=uniqueness, subpixel=subpixel,
              lr_check=lr_check)
    if cl0.device.type == "cpu":
        SHARDED_COUNTER.plain_calls += 1
        return sgm_fused_sharded_plain(cl0, cl1, cr0, cr1, *carries(), **kw)
    _check_k1_params(p2, num_disparities, min_disparity)
    h, w = _check_census(cl0, cl1, cr0, cr1)
    lib = build.library()
    census = (cl0.data_ptr(), cl1.data_ptr(), cr0.data_ptr(), cr1.data_ptr())
    main = torch.cuda.current_stream(cl0.device)
    out = torch.empty((h, w), dtype=torch.int16, device=cl0.device)
    side.wait_stream(main)  # the census words
    with torch.cuda.stream(side):
        vol = _path_volume(h, w, num_disparities, torch.uint8, cl0.device)
    build.check(lib.sgm_sharded_rows(*census, vol.data_ptr(), h, w, num_disparities,
                                     min_disparity, p1, p2, side.cuda_stream),
                "sgm_sharded_rows")

    def output(tb, bt):
        _check_carries(tb, bt, w, num_disparities, cl0.device)
        side.wait_stream(main)  # the settle sweeps that made tb and bt
        build.check(lib.sgm_sharded_cols(*census, vol.data_ptr(), build.ptr(tb),
                                         build.ptr(bt), h, w, num_disparities, min_disparity,
                                         p1, p2, side.cuda_stream), "sgm_sharded_cols")
        build.check(lib.sgm_wta(vol.data_ptr(), out.data_ptr(), h, w, num_disparities,
                                min_disparity, uniqueness, int(subpixel), int(lr_check),
                                side.cuda_stream), "sgm_wta")

    carries(output)
    main.wait_stream(side)  # the join
    SHARDED_COUNTER.launches += 1
    return out


def sgm_aggregate_plain(cl0, cl1, cr0, cr1, *, min_disparity: int, num_disparities: int,
                        p1: int, p2: int) -> torch.Tensor:
    """The plain version of K6: cost volume, then the 4-path sum, as int16."""
    cost = stereo.hamming_cost_volume((cl0, cl1), (cr0, cr1), min_disparity, num_disparities)
    return stereo.sgm_aggregate(cost, p1, p2).to(torch.int16)


@build.on_its_card
def sgm_aggregate(cl0, cl1, cr0, cr1, *, min_disparity: int, num_disparities: int,
                  p1: int, p2: int) -> torch.Tensor:
    """Census words (int32 [H, W] x2 per view) -> the 4-path aggregated cost
    int16 [H, W, D], d ascending: the counterpart of sgm_aggregate_pallas.
    Takes the JAX op's parameter range (p2 <= 8000): the kernel's path
    kernels add their int16 values into the output, which is all the memory
    the call takes (no path volume)."""
    stereo.check_sgm_params(p1, p2)
    kw = dict(min_disparity=min_disparity, num_disparities=num_disparities, p1=p1, p2=p2)
    if cl0.device.type == "cpu":
        AGGREGATE_COUNTER.plain_calls += 1
        return sgm_aggregate_plain(cl0, cl1, cr0, cr1, **kw)
    _check_range(num_disparities, min_disparity)
    h, w = _check_census(cl0, cl1, cr0, cr1)
    out = torch.empty((h, w, num_disparities), dtype=torch.int16, device=cl0.device)
    build.check(build.library().sgm_aggregate(
        cl0.data_ptr(), cl1.data_ptr(), cr0.data_ptr(), cr1.data_ptr(), out.data_ptr(), h, w,
        num_disparities, min_disparity, p1, p2, build.stream()), "sgm_aggregate")
    AGGREGATE_COUNTER.launches += 1
    return out
