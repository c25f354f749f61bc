"""K5's settle schedule (parallel/sgm_sharded.settled_carries) on the CPU.

The chain sweeps only what it keeps: in round j shard j sweeps top-down and
shard n-1-j bottom-up.  Held here, at 48x64 census words and D = 32:

  * on every shard, the settled carries equal those of the all-shards
    schedule (every shard sweeping both directions in every round, replayed
    here from ``sgm_vcarry_plain``) and the full-frame scan's state at the
    shard's edges, for 1, 2, 3, 4 and 8 shards;
  * exactly 2(n-1) direction-sweeps run, shard j top-down and shard n-1-j
    bottom-up in round j, one call each (one call for both at odd n's
    middle shard);
  * the sharded disparity equals the JAX sharded op under a shard_map and
    the JAX full frame for 2 and 4 shards;
  * ``on_settled`` runs once per shard, after the sweeps that made its
    carries and before any shard leaves the chain;
  * the shard group's ``ppermute`` hands on "nothing" as None, and
    ``ppermutes`` and ``barrier``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cartslam_tpu.ops import color as jcolor
from cartslam_tpu.ops import stereo as jstereo
from cartslam_tpu.parallel.sgm_sharded import sgm_disparity_sharded as jsharded
from cartslam_tpu.sources.synthetic import SyntheticDataSource
from cartslam_tpu_torch.kernels import build as kbuild
from cartslam_tpu_torch.kernels import sgm as ksgm
from cartslam_tpu_torch.ops import stereo as tstereo
from cartslam_tpu_torch.parallel.group import ShardGroup
from cartslam_tpu_torch.parallel.sgm_sharded import (chain_perms, sgm_census_sharded,
                                                     sgm_disparity_sharded, settled_carries)
from cartslam_tpu_torch.runtime.module import SpatialContext

H, W = 48, 64
CKW = dict(min_disparity=1, num_disparities=32, p1=10, p2=120)
SGM_KW = dict(CKW, uniqueness=12)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread, as the shard threads use (parallel/group.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _group(n):
    group = ShardGroup(n, ["cpu"] * n)
    return group, SpatialContext(group, H // n)


@pytest.fixture(scope="module")
def census():
    """Census words of a synthetic pair (int32 [H, W] x2 per view)."""
    src = SyntheticDataSource(image_size=(H, W), num_frames=1, seed=0, max_disparity=20.0,
                              baseline=8.0)
    f = src.get_next()
    to_gray = jax.jit(jcolor.bgr_to_gray)
    words = []
    for view in ("left", "right"):
        words += [torch.from_numpy(np.array(c)) for c in
                  jstereo.census_transform(to_gray(f[view]))]
    return words


def _shard_rows(words, i, n):
    h = H // n
    return [w[i * h:(i + 1) * h].contiguous() for w in words]


def all_shards_carries(settle, sp):
    """The schedule before the exact one: n-1 rounds in which every shard
    sweeps both directions from its current carries and hands both on."""
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


def _full_frame_scans(words):
    """The full frame's top-down and bottom-up scan states [H, W, D] (row y
    of the bottom-up one is its state after row H-1-y)."""
    cost = tstereo.hamming_cost_volume(tuple(words[:2]), tuple(words[2:]),
                                       CKW["min_disparity"], CKW["num_disparities"])
    chwd = cost.permute(1, 2, 0)
    return (tstereo._aggregate_scan(chwd, CKW["p1"], CKW["p2"]),
            tstereo._aggregate_scan(chwd.flip(0), CKW["p1"], CKW["p2"]))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_exact_schedule_matches_all_shards_schedule(census, n):
    group, sp = _group(n)
    h = H // n
    calls = []  # (shard, top_down, bottom_up) of every settle call

    def shard(i):
        rows = _shard_rows(census, i, n)

        def recording(tb, bt, down, up):
            calls.append((i, down, up))
            return ksgm.sgm_vcarry_plain(*rows, tb, bt, top_down=down, bottom_up=up, **CKW)

        new = settled_carries(recording, sp)
        old = all_shards_carries(lambda tb, bt: ksgm.sgm_vcarry_plain(*rows, tb, bt, **CKW), sp)
        return new, old

    results = group.run(shard)
    tb_full, bt_full = _full_frame_scans(census)
    for i, ((tb, bt), (tb_old, bt_old)) in enumerate(results):
        assert (tb is None) == (i == 0) and (bt is None) == (i == n - 1)
        assert (tb_old is None) == (tb is None) and (bt_old is None) == (bt is None)
        if tb is not None:
            assert torch.equal(tb, tb_old), f"shard {i}: top-down carry"
            assert torch.equal(tb, tb_full[i * h - 1]), f"shard {i}: top-down vs full frame"
        if bt is not None:
            assert torch.equal(bt, bt_old), f"shard {i}: bottom-up carry"
            assert torch.equal(bt, bt_full[H - (i + 1) * h - 1]), f"shard {i}: bottom-up"

    # 2(n-1) direction-sweeps: in round j shard j top-down and shard n-1-j
    # bottom-up, one call each, one call for both where they meet.
    assert sum(down + up for _, down, up in calls) == 2 * (n - 1)
    want = [(i, i == j, i == n - 1 - j) for j in range(n - 1) for i in {j, n - 1 - j}]
    assert sorted(calls) == sorted(want)
    assert len(calls) == 2 * (n - 1) - (n % 2 == 1 and n > 1)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_on_settled_runs_once_after_its_producers_and_before_any_return(census, n):
    """on_settled(tb, bt) runs once per shard with the carries it returns,
    after the sweeps that made them, and every shard's runs before any
    shard returns from the chain (its closing barrier)."""
    group, sp = _group(n)
    log = []  # the shards take turns on the host: appends are in order

    def shard(i):
        rows = _shard_rows(census, i, n)

        def settle(tb, bt, down, up):
            log.append(("sweep", i, down, up))
            return ksgm.sgm_vcarry_plain(*rows, tb, bt, top_down=down, bottom_up=up, **CKW)

        seen = []
        got = settled_carries(settle, sp, lambda tb, bt: (seen.append((tb, bt)),
                                                          log.append(("settled", i))))
        log.append(("return", i))
        return got, seen

    for i, (got, seen) in enumerate(group.run(shard)):
        assert len(seen) == 1 and all(a is b for a, b in zip(seen[0], got))
        at = log.index(("settled", i))
        if i > 0:
            assert ("sweep", i - 1, True, i - 1 == n - i) in log[:at]
        if i < n - 1:
            assert ("sweep", i + 1, i + 1 == n - 2 - i, True) in log[:at]
    first_return = min(k for k, e in enumerate(log) if e[0] == "return")
    assert sum(e[0] == "settled" for e in log[:first_return]) == n


def test_settle_wrapper_sweeps_the_directions_asked_for(census):
    """sgm_vcarry (its plain route on CPU tensors) from given carries: one
    direction gives that direction's carry of a both-directions sweep and
    None for the other; each call counts one plain call of sgm_settle."""
    rng = np.random.default_rng(5)
    rows = _shard_rows(census, 1, 4)
    tb, bt = (torch.from_numpy(rng.integers(0, 300, (W, 32)).astype(np.int32))
              for _ in range(2))
    both = ksgm.sgm_vcarry_plain(*rows, tb, bt, **CKW)
    kbuild.reset_counts()
    down = ksgm.sgm_vcarry(*rows, tb, None, top_down=True, bottom_up=False, **CKW)
    up = ksgm.sgm_vcarry(*rows, None, bt, top_down=False, bottom_up=True, **CKW)
    assert down[1] is None and torch.equal(down[0], both[0])
    assert up[0] is None and torch.equal(up[1], both[1])
    assert ksgm.SETTLE_COUNTER.plain_calls == 2 and ksgm.SETTLE_COUNTER.launches == 0
    with pytest.raises(ValueError, match="no direction"):
        ksgm.sgm_vcarry(*rows, tb, bt, top_down=False, bottom_up=False, **CKW)


@pytest.fixture(scope="module")
def gray_pair():
    src = SyntheticDataSource(image_size=(H, W), num_frames=1, seed=1, max_disparity=20.0,
                              baseline=8.0)
    f = src.get_next()
    to_gray = jax.jit(jcolor.bgr_to_gray)
    gl, gr = np.asarray(to_gray(f["left"])), np.asarray(to_gray(f["right"]))
    full = np.asarray(jax.jit(functools.partial(jstereo.sgm_disparity, backend="xla",
                                                **SGM_KW))(gl, gr))
    return gl, gr, full


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_disparity_matches_jax(gray_pair, n):
    """The port's sharded SGM (the kernel wrappers' plain routes and
    plain=True) against the JAX sharded op under an n-device shard_map (XLA
    route) and the JAX full frame."""
    gl, gr, full = gray_pair
    ax = "spatial"
    mesh = Mesh(np.array(jax.devices()[:n]), (ax,))
    shard = NamedSharding(mesh, P(ax))
    fn = jax.jit(jax.shard_map(functools.partial(jsharded, axis_name=ax, backend="xla",
                                                 **SGM_KW),
                               mesh=mesh, in_specs=(P(ax), P(ax)), out_specs=P(ax)))
    want = np.asarray(fn(jax.device_put(gl, shard), jax.device_put(gr, shard)))
    np.testing.assert_array_equal(want, full)
    group, sp = _group(n)
    h = H // n
    rows = lambda x, i: torch.from_numpy(x[i * h:(i + 1) * h].copy())
    kbuild.reset_counts()
    got = group.run(lambda i: sgm_disparity_sharded(rows(gl, i), rows(gr, i), sp, **SGM_KW))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    assert ksgm.SHARDED_COUNTER.plain_calls == n
    assert ksgm.SETTLE_COUNTER.plain_calls == 2 * (n - 1)  # n even: one call per sweep

    # plain=True on the census words: the same schedule, both plain steps.
    words = [torch.from_numpy(np.array(c)) for g in (gl, gr)
             for c in jstereo.census_transform(g)]
    got_plain = group.run(lambda i: sgm_census_sharded(
        *_shard_rows(words, i, n), sp, plain=True, subpixel=True, lr_check=True, **SGM_KW))
    np.testing.assert_array_equal(torch.cat(got_plain).numpy(), want)


def test_ppermutes_and_barrier():
    """ppermutes: several ppermutes in one collective, each as ppermute
    alone would route it; barrier: no shard passes before all arrive."""
    n = 4
    group = ShardGroup(n, ["cpu"] * n)
    fwd, bwd = [(i, i + 1) for i in range(n - 1)], [(i, i - 1) for i in range(1, n)]
    arrived = []

    def shard(i):
        x = torch.full((2,), i)
        got = group.ppermutes((x, fwd), (None if i == 2 else 10 + x, bwd))
        arrived.append(i)
        group.barrier()
        return got, len(arrived)

    for i, ((down, up), seen) in enumerate(group.run(shard)):
        assert seen == n
        zeros = torch.zeros(2, dtype=torch.int64)
        assert torch.equal(down, torch.full((2,), i - 1) if i else zeros)
        if i == 1:
            assert up is None  # shard 2 handed on nothing
        elif i == n - 1:
            assert torch.equal(up, zeros)
        else:
            assert torch.equal(up, torch.full((2,), 11 + i))


def test_ppermute_hands_on_nothing_as_none():
    """A shard that passes None hands on nothing: its destination gets None
    (not zeros); a shard that is no destination gets zeros of its x, or None
    if it passed None."""
    n = 4
    group = ShardGroup(n, ["cpu"] * n)
    fwd = [(i, i + 1) for i in range(n - 1)]

    def shard(i):
        x = torch.full((2, 3), i + 1) if i % 2 == 0 else None
        return x, group.ppermute(x, fwd), group.ppermute(x, [(0, 2)])

    got = group.run(shard)
    # i -> i+1: shard 1 gets shard 0's x and shard 3 shard 2's; shard 2 gets
    # the None of shard 1; shard 0 is no destination.
    _, fwd0, _ = got[0]
    assert torch.equal(fwd0, torch.zeros(2, 3, dtype=torch.int64))
    assert torch.equal(got[1][1], torch.full((2, 3), 1))
    assert got[2][1] is None
    assert torch.equal(got[3][1], torch.full((2, 3), 3))
    # perm (0, 2): shard 2 gets shard 0's x; shard 1 and 3 passed None and
    # are no destination: None; shard 0 is no destination: zeros.
    assert torch.equal(got[2][2], torch.full((2, 3), 1))
    assert got[1][2] is None and got[3][2] is None
    assert torch.equal(got[0][2], torch.zeros(2, 3, dtype=torch.int64))
