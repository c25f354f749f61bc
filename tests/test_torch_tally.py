"""Kernels K2 (moment tally) and K4 (vote tally) of the port, on the CPU.

Held here:

  * K2's and K4's plain versions against the JAX package's TPU kernels
    (``moment_tally_pallas`` / ``vote_tally_pallas`` in interpret mode, as
    tests/test_tally.py runs them), with out-of-range labels (-1 and >= L),
    votes equal to P, and K2's data at both ends of its domain;
  * the pure-Python parts of the wrappers: the tiling (every quad of the
    pixels read by exactly one (tile, row, lane), replayed in Python from the
    kernels' indexing), the scratch shapes, one counter increment a call,
    and the image layout ([H, W] labels) giving the flat call's table;
  * a reference-faithful ``relax`` call ('phase' statistics: a K2 tally per
    sub-step) converting its float planes to int32 once.

The kernels themselves run only on the card: chip_smoke.py holds them
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cartslam_tpu.ops.pallas.tally import moment_tally_pallas, vote_tally_pallas
from cartslam_tpu_torch.kernels import build as kbuild
from cartslam_tpu_torch.kernels import tally as ktally
from cartslam_tpu_torch.ops import superpixels as tsp

F32_EXACT = 2**24


def _exact_table(lab, data, num):
    """The exact int64 moment table of numpy's int64 sums."""
    keep = (lab >= 0) & (lab < num)
    d = data[:, keep].astype(np.int64)
    rows = np.concatenate([np.ones_like(d[:1]), d, d * d])
    acc = np.zeros((rows.shape[0], num), np.int64)
    for r in range(rows.shape[0]):
        np.add.at(acc[r], lab[keep], rows[r])
    return acc


def _moment_inputs(case, rng, n=4096, num=300, c=7):
    lab = rng.randint(-1, num + 2, n).astype(np.int32)  # -1, L and L + 1 drop
    if case == "in range":
        data = rng.randint(-700, 701, (c, n))
    else:  # one pixel of each label at the domain's end (-32768 or 32767) in every channel
        data = rng.randint(-700, 701, (c, n))
        _, first = np.unique(lab, return_index=True)
        data[:, first] = ktally.DATA_MIN if case == "at -32768" else ktally.DATA_MAX
    return lab, data.astype(np.int32), num


@pytest.mark.parametrize("case", ["in range", "at -32768", "at 32767"])
def test_moment_tally_plain_matches_jax_pallas(case):
    """Every entry below 2^24 (where the JAX kernel's float32 sums are exact)
    is equal; the square sums of the domain's ends pass 2^24, where the JAX
    kernel rounds in its byte-plane combine (tests/test_tally.py's rtol) and
    the port rounds the exact sum once."""
    lab, data, num = _moment_inputs(case, np.random.RandomState(11))
    got = ktally.moment_tally_plain(torch.from_numpy(lab), torch.from_numpy(data), num).numpy()
    want = np.asarray(moment_tally_pallas(jnp.asarray(lab), jnp.asarray(data.astype(np.float32)),
                                          num, interpret=True))
    exact = _exact_table(lab, data, num)
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    small = np.abs(exact) < F32_EXACT
    assert small[: 1 + 7].all()  # counts and sums stay below 2^24 in every case
    np.testing.assert_array_equal(got[small], want[small])
    np.testing.assert_allclose(got[~small], want[~small], rtol=2e-7, atol=0)
    if case != "in range":
        assert (~small).any()
    assert exact[0].sum() == ((lab >= 0) & (lab < num)).sum()


def test_vote_tally_plain_matches_jax_pallas():
    rng = np.random.RandomState(12)
    n, num, p = 8192, 500, 3
    lab = rng.randint(-1, num + 2, n).astype(np.int32)
    votes = rng.randint(0, p + 1, n).astype(np.uint8)  # p drops
    got = ktally.vote_tally_plain(torch.from_numpy(lab), torch.from_numpy(votes), num, p)
    want = np.asarray(vote_tally_pallas(jnp.asarray(lab), jnp.asarray(votes.astype(np.int32)),
                                        num, p, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    keep = (lab >= 0) & (lab < num) & (votes < p)
    assert int(got.sum()) == keep.sum() < n


def _quads_read(shape):
    """Every quad index the kernels read for a label array of `shape`,
    replayed from csrc/tally.cu's quad_of over every (tile, row, lane)."""
    t = ktally.tiling(shape)
    nq = -(-int(np.prod(shape)) // 4)
    tile = np.arange(t.count)[:, None, None]
    row = np.arange(ktally.TILE_ROWS)[None, :, None]
    lane = np.arange(ktally.TILE_QUADS)[None, None, :]
    c = (tile % t.cols) * ktally.TILE_QUADS + lane
    q = ((tile // t.cols) * ktally.TILE_ROWS + row) * t.quads_per_row + c
    q = np.broadcast_to(q, (t.count, ktally.TILE_ROWS, ktally.TILE_QUADS))
    inside = (np.broadcast_to(c, q.shape) < t.quads_per_row) & (q < nq)
    return np.sort(q[inside]), nq


@pytest.mark.parametrize("shape", [(376, 1248), (47, 1248), (63, 1248), (37, 61), (5, 3),
                                   (469248,), (58693,), (4096,), (1,), (0,)])
def test_tiling_reads_every_quad_once(shape):
    quads, nq = _quads_read(shape)
    np.testing.assert_array_equal(quads, np.arange(nq))


def test_tiling_sizes():
    t = ktally.tiling((376, 1248))  # the flagship's labels: 16 x 128-pixel tiles
    assert (t.quads_per_row, t.cols, t.count) == (312, 10, 240)
    assert ktally.tiling((47, 1248)).count == 30  # a spatial shard
    t = ktally.tiling((469248,))  # a flat array: contiguous 2048-pixel chunks
    assert (t.quads_per_row, t.cols, t.count) == (32, 1, 230)
    assert ktally.tiling((37, 61)).quads_per_row == 16  # rows rounded up to whole quads
    assert ktally.tiling((0,)).count == 0


def test_moment_scratch_shapes():
    assert ktally.moment_scratch(7, 3329, None) == ((15, 3329), (15, 3329))
    assert ktally.moment_scratch(5, 10, lambda a: a) == ((11, 10), None)


def test_wrappers_count_one_call_and_take_the_image_layout():
    rng = np.random.RandomState(13)
    num = 40
    labels = torch.from_numpy(rng.randint(-1, num + 1, (24, 36)).astype(np.int32))
    data = torch.from_numpy(rng.randint(-500, 500, (3, 24, 36)).astype(np.int32))
    votes = torch.from_numpy(rng.randint(0, 4, (24, 36)).astype(np.uint8))
    kbuild.reset_counts()
    table = ktally.moment_tally(labels, data, num)
    summed = ktally.moment_tally(labels, data, num, reduce=lambda acc: acc * 2)
    counts = ktally.vote_tally(labels, votes, num, 3)
    moment, vote = kbuild.COUNTERS["moment_tally"], kbuild.COUNTERS["vote_tally"]
    assert (moment.plain_calls, moment.launches, vote.plain_calls, vote.launches) == (2, 0, 1, 0)
    flat = ktally.moment_tally_plain(labels.reshape(-1), data.reshape(3, -1), num)
    torch.testing.assert_close(table, flat, rtol=0, atol=0)
    torch.testing.assert_close(summed, 2 * flat, rtol=0, atol=0)
    torch.testing.assert_close(
        counts, ktally.vote_tally_plain(labels.reshape(-1), votes.reshape(-1), num, 3),
        rtol=0, atol=0)


class _Int32Planes(TorchDispatchMode):
    """Counts the conversions (aten._to_copy) that produce int32 tensors of
    `numel` elements, in any shape."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.n = numel, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func is torch.ops.aten._to_copy.default and out.dtype == torch.int32
                and out.numel() == self.numel):
            self.n += 1
        return out


def test_faithful_relax_converts_the_planes_once():
    """'phase' statistics re-tally after every sub-step (K2 once per
    sub-step): the int32 planes [C, H, W] are converted once a call."""
    h, w, iterations, phases = 24, 48, 2, 2
    rng = np.random.RandomState(14)
    labels, num = tsp.block_init_labels(h, w, 6, 6)
    deriv = torch.from_numpy(rng.randint(-30, 30, (h, w, 2)).astype(np.float32))
    ycrcb = torch.from_numpy(rng.randint(0, 256, (h, w, 3)).astype(np.float32))
    specs = [tsp.FeatureSpec("gaussian", 1.0, 2), tsp.FeatureSpec("gaussian", 1.5, 3),
             tsp.FeatureSpec("compactness", 0.1, 2)]
    kbuild.reset_counts()
    with _Int32Planes(7 * h * w) as mode:
        tsp.relax(labels, [deriv, ycrcb], specs, num, iterations, 0.5, 0.3536, phases=phases,
                  stats_refresh="phase")
    assert kbuild.COUNTERS["moment_tally"].plain_calls == iterations * phases
    assert mode.n == 1
