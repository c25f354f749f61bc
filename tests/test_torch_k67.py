"""Kernels K6 (4-path aggregated volume) and K7 (label tally) of the port,
on the CPU.

Held here:

  * K6's wrapper on CPU tensors (its plain version) against the JAX
    package's TPU kernel ``sgm_aggregate_pallas`` in interpret mode, at
    tests/test_pallas_sgm.py's shapes;
  * K7's wrappers on CPU tensors (ops/tally.label_tally in the JAX
    function's [B, C] form, kernels/tally.label_tally channel-major) against
    ``label_tally_pallas`` in interpret mode at 19 and 50 columns, as
    tests/test_tally.py runs it;
  * the channel-major K7's Python-level contract: flat [N] and image [H, W]
    labels giving the same [C, L] table on a ragged shape, any int32 value,
    labels outside [0, L) dropped, `reduce` taking the exact int64 [C, L]
    table before the one rounding;
  * init_stats' 9-channel route: the rows [1, d, d^2] handed to K7 as
    [19, H, W] beside the [H, W] labels, one K7 call and no K2 call, the
    table equal to the JAX package's.

The kernels themselves run only on the card: chip_smoke.py holds them
against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartslam_tpu.ops import stereo as jstereo
from cartslam_tpu.ops import superpixels as jsp
from cartslam_tpu.ops.pallas.sgm import sgm_aggregate_pallas
from cartslam_tpu.ops.pallas.tally import label_tally_pallas
from cartslam_tpu_torch.kernels import sgm as ksgm
from cartslam_tpu_torch.kernels import tally as ktally
from cartslam_tpu_torch.ops import stereo as tstereo
from cartslam_tpu_torch.ops import superpixels as tsp
from cartslam_tpu_torch.ops import tally as ttally


def _texture_pair(h, w, d, seed):
    """tests/test_pallas_sgm.py's stereo pair: a random texture shifted by d."""
    rng = np.random.RandomState(seed)
    tex = rng.randint(0, 255, (h, w + d)).astype(np.uint8)
    return tex[:, d:], tex[:, :w]


@pytest.mark.parametrize("h, w, d, min_d, p1, p2, seed", [
    (24, 60, 16, 0, 10, 120, 0),  # 60 % 8 != 0: the TPU kernel's padded columns
    (24, 64, 16, 0, 10, 120, 0),
    (16, 44, 8, 2, 7, 86, 3),
])
def test_sgm_aggregate_matches_jax_pallas(h, w, d, min_d, p1, p2, seed):
    left, right = _texture_pair(h, w, d, seed)
    kw = dict(min_disparity=min_d, num_disparities=d, p1=p1, p2=p2)
    want = np.asarray(sgm_aggregate_pallas(jstereo.census_transform(jnp.asarray(left)),
                                           jstereo.census_transform(jnp.asarray(right)),
                                           interpret=True, **kw))
    cl = tstereo.census_transform(torch.from_numpy(left))
    cr = tstereo.census_transform(torch.from_numpy(right))
    before = (ksgm.AGGREGATE_COUNTER.plain_calls, ksgm.AGGREGATE_COUNTER.launches)
    got = ksgm.sgm_aggregate(*cl, *cr, **kw)
    assert (ksgm.AGGREGATE_COUNTER.plain_calls, ksgm.AGGREGATE_COUNTER.launches) == (
        before[0] + 1, before[1])  # CPU tensors: the plain version, no launch
    assert got.dtype == torch.int16 and got.shape == (h, w, d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [19, 50])
def test_label_tally_matches_jax_pallas(c):
    """bf16-exact values (the JAX kernel's contract), B = 8192: both of the
    port's wrappers equal the TPU kernel's table."""
    rng = np.random.RandomState(c)
    b, num = 8192, 300
    labels = rng.randint(0, num, b).astype(np.int32)
    values = rng.randint(-256, 257, (b, c)).astype(np.int32)
    want = np.asarray(label_tally_pallas(jnp.asarray(labels), jnp.asarray(values.astype(np.float32)),
                                         num, interpret=True))
    lab, val = torch.from_numpy(labels), torch.from_numpy(values)
    before = ktally.LABEL_COUNTER.plain_calls
    got = ttally.label_tally(lab, val, num)
    by_channel = ktally.label_tally(lab, val.T.contiguous(), num)
    assert ktally.LABEL_COUNTER.plain_calls == before + 2
    assert got.dtype == torch.float32 and got.shape == (num, c) and got.is_contiguous()
    assert by_channel.shape == (c, num) and by_channel.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(by_channel.numpy(), want.T)


def _exact(labels, values, num):
    """numpy's exact int64 per-label sums [C, L] of values [C, N]."""
    keep = (labels >= 0) & (labels < num)
    out = np.zeros((values.shape[0], num), np.int64)
    for ch in range(values.shape[0]):
        np.add.at(out[ch], labels[keep], values[ch][keep].astype(np.int64))
    return out


def test_label_tally_layouts_values_and_reduce():
    """A ragged image (37 x 133: neither a multiple of the 16 x 128 tiles nor
    of 4 pixels), labels over [-2, L + 2), values over the whole int32 range
    with +-2^30 in places: image and flat layouts give the exact sums
    rounded once; `reduce` gets the int64 [C, L] table first."""
    rng = np.random.RandomState(9)
    h, w, c, num = 37, 133, 5, 40
    labels = rng.randint(-2, num + 2, (h, w)).astype(np.int32)
    values = rng.randint(-2**31, 2**31, (c, h, w), dtype=np.int64).astype(np.int32)
    values[1, ::3] = 2**30
    values[2, ::2] = -2**30
    exact = _exact(labels.reshape(-1), values.reshape(c, -1), num)
    lab, val = torch.from_numpy(labels), torch.from_numpy(values)
    image = ktally.label_tally(lab, val, num)
    flat = ktally.label_tally(lab.reshape(-1), val.reshape(c, -1), num)
    np.testing.assert_array_equal(image.numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(flat.numpy(), image.numpy())
    assert (np.abs(exact) >= 2**24).any()  # the rounding rule is exercised
    # A flat run from the second pixel on (an unaligned start on the card).
    part = slice(1, h * w - 3)
    got = ktally.label_tally(lab.reshape(-1)[part], val.reshape(c, -1)[:, part], num)
    np.testing.assert_array_equal(
        got.numpy(), _exact(labels.reshape(-1)[part], values.reshape(c, -1)[:, part],
                            num).astype(np.float32))
    seen = []
    doubled = ktally.label_tally(lab, val, num, reduce=lambda acc: seen.append(acc) or acc * 2)
    assert seen[0].dtype == torch.int64 and seen[0].shape == (c, num)
    np.testing.assert_array_equal(seen[0].numpy(), exact)
    np.testing.assert_array_equal(doubled.numpy(), (exact * 2).astype(np.float32))
    # The [B, C] entry point hands reduce the same channel-major table.
    seen.clear()
    ttally.label_tally(lab.reshape(-1), val.reshape(c, -1).T, num, reduce=lambda a: seen.append(a) or a)
    np.testing.assert_array_equal(seen[0].numpy(), exact)


def test_init_stats_nine_channels_route(monkeypatch):
    """Nine channels: K7 gets the rows [1, d, d^2] as [19, H, W] beside the
    [H, W] labels (no transpose on either side), once, and K2 not at all;
    the table equals the JAX package's init_stats (exact here); psum
    reaches K7's reduce."""
    rng = np.random.RandomState(4)
    h, w, num = 20, 29, 11
    labels = rng.randint(-1, num, (h, w)).astype(np.int32)
    data = rng.randint(-60, 256, (9, h, w)).astype(np.float32)
    want = np.asarray(jsp.init_stats(jnp.asarray(labels), jnp.asarray(data), num,
                                     use_matmul=False))
    calls = []
    tally = ktally.label_tally
    monkeypatch.setattr(ktally, "label_tally", lambda lab, val, n, reduce=None: (
        calls.append((tuple(lab.shape), tuple(val.shape), val.dtype)) or tally(lab, val, n, reduce)))
    before = (ktally.LABEL_COUNTER.plain_calls, ktally.MOMENT_COUNTER.plain_calls)
    got = tsp.init_stats(torch.from_numpy(labels), torch.from_numpy(data), num)
    assert calls == [((h, w), (19, h, w), torch.int32)]
    assert (ktally.LABEL_COUNTER.plain_calls, ktally.MOMENT_COUNTER.plain_calls) == (
        before[0] + 1, before[1])
    assert got.shape == (19, num) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    tables = []
    summed = tsp.init_stats(torch.from_numpy(labels), torch.from_numpy(data), num,
                            psum=lambda acc: tables.append(acc) or acc + acc)
    assert tables[0].shape == (19, num) and tables[0].dtype == torch.int64
    np.testing.assert_array_equal(summed.numpy(), 2 * want)
