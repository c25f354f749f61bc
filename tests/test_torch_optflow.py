"""Parity of the port's optical flow (ops/optflow.py, models/optflow.py) with
the JAX package's, on the CPU.

Every value of the flow pyramid is exact in float32 (dyadic pyramid values,
integer flow), so every output must be equal, not close.  The JAX search is
its scan form, the route it takes on every backend but the TPU; dense_flow
is called jitted, as the JAX module calls it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartslam_tpu.ops import optflow as jflow
from cartslam_tpu_torch.kernels import median as kmedian
from cartslam_tpu_torch.ops import optflow as tflow


def t(a):
    return torch.from_numpy(np.array(a))


def texture(h, w, seed):
    """Blocky multi-scale uint8 texture (SAD matches are unambiguous)."""
    rng = np.random.RandomState(seed)
    tex = np.zeros((h, w), np.float32)
    for scale, amp in ((8, 60.0), (3, 40.0)):
        base = rng.randn(h // scale + 2, w // scale + 2)
        tex += amp * np.kron(base, np.ones((scale, scale)))[:h, :w]
    tex += rng.randn(h, w) * 6
    return np.clip(tex + 128, 0, 255).astype(np.uint8)


def moving_pair(h, w, dy, dx, seed):
    """(cur, prev) with cur[y, x] = prev[y - dy, x - dx] inside the frame."""
    big = texture(h + 2 * abs(dy), w + 2 * abs(dx), seed)
    ay, ax = abs(dy), abs(dx)
    prev = big[ay : ay + h, ax : ax + w]
    cur = big[ay - dy : ay - dy + h, ax - dx : ax - dx + w]
    return np.ascontiguousarray(cur), np.ascontiguousarray(prev)


def dyadic(shape, level, seed):
    """Pyramid-like values: integers 0..255 scaled by 4^-level."""
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256 * 4**level, shape) / 4.0**level).astype(np.float32)


@pytest.mark.parametrize("shape", [(12, 20), (13, 21)])
def test_avg_pool2_matches_jax(shape):
    x = dyadic(shape, 2, seed=shape[0])
    ref = np.asarray(jflow._avg_pool2(jnp.asarray(x)))
    out = tflow._avg_pool2(t(x)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("r", [2, 4])
def test_box_sum_matches_jax(r):
    """r=2 is the JAX function's shift-add route, r=4 its cumsum route; the
    port's shift-adds equal both on dyadic values."""
    x = dyadic((17, 23), 1, seed=r)
    ref = np.asarray(jflow._box_sum(jnp.asarray(x), r))
    out = tflow._box_sum(t(x), r).numpy()
    np.testing.assert_array_equal(out, ref)


def test_median3x3_matches_jax():
    """Small integer range, so ties are frequent; both channels at once."""
    rng = np.random.RandomState(5)
    x = rng.randint(-3, 4, (2, 15, 22)).astype(np.float32)
    out = tflow._median3x3(t(x)).numpy()
    for c in range(2):
        np.testing.assert_array_equal(out[c], np.asarray(jflow._median3x3(jnp.asarray(x[c]))))


# Edge shapes (a single row, column or pixel), shapes under and across the
# card kernel's 32 x 32 tile, and test_median3x3_matches_jax's.
MEDIAN_SHAPES = [(1, 1), (1, 7), (7, 1), (2, 2), (3, 5), (33, 65), (15, 22)]
_jax_median = jax.jit(jflow._median3x3)


@pytest.mark.parametrize("planes", [(), (2,)], ids=["hw", "2hw"])
@pytest.mark.parametrize("passes", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", MEDIAN_SHAPES, ids=[f"{h}x{w}" for h, w in MEDIAN_SHAPES])
def test_median3x3_passes_match_jax(shape, passes, planes):
    """The wrapper's plain path equals the JAX network applied `passes` times
    to each plane; small integer values, so ties are frequent."""
    rng = np.random.RandomState(passes * 100 + shape[0] * 7 + shape[1])
    x = rng.randint(-3, 4, (*planes, *shape)).astype(np.float32)
    before = kmedian.MEDIAN_COUNTER.plain_calls
    out = kmedian.median3x3(t(x), passes)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert kmedian.MEDIAN_COUNTER.plain_calls == before + (passes > 0)
    for idx in np.ndindex(*planes):
        ref = jnp.asarray(x[idx])
        for _ in range(passes):
            ref = _jax_median(ref)
        np.testing.assert_array_equal(out.numpy()[idx], np.asarray(ref))


@pytest.mark.parametrize("x,passes", [
    (torch.zeros((4, 4), dtype=torch.float64), 2),
    (torch.zeros((4, 4), dtype=torch.int32), 2),
    (torch.zeros((2, 4, 4), dtype=torch.float16), 1),
    (torch.zeros(5), 2),
    (torch.zeros(()), 1),
    (torch.zeros((4, 4)), -1),
], ids=["float64", "int32", "float16", "1-d", "0-d", "negative-passes"])
def test_median3x3_refuses(x, passes):
    with pytest.raises(ValueError, match="median3x3"):
        kmedian.median3x3(x, passes)


def test_warp_backward_matches_jax():
    """Integer flow (as the pyramid has), sources clamped at every edge."""
    rng = np.random.RandomState(6)
    img = dyadic((14, 19), 1, seed=7)
    flow = rng.randint(-20, 21, (14, 19, 2)).astype(np.float32)
    ref = np.asarray(jflow._warp_backward(jnp.asarray(img), jnp.asarray(flow)))
    out = tflow._warp_backward(t(img), t(np.moveaxis(flow, -1, 0))).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("radius", [1, 4])
def test_search_level_matches_jax_scan(radius):
    cur, prev = moving_pair(20, 31, 1, -2, seed=radius)
    cur, prev = cur.astype(np.float32) / 4, prev.astype(np.float32) / 4
    prev[5:9, 5:12] = 64.0  # a flat patch: ties broken by the zero-motion bias
    cur[5:9, 5:12] = 64.0
    rdx, rdy = jflow._search_level_scan(jnp.asarray(cur), jnp.asarray(prev), radius, 2)
    odx, ody = tflow._search_level(t(cur), t(prev), radius, 2)
    np.testing.assert_array_equal(odx.numpy(), np.asarray(rdx))
    np.testing.assert_array_equal(ody.numpy(), np.asarray(rdy))
    assert (np.asarray(rdx) != 0).any()


@pytest.mark.parametrize("shape,motion", [((48, 96), (2, -5)), ((50, 70), (-3, 7))],
                         ids=["48x96", "50x70-padded"])
def test_dense_flow_matches_jax(shape, motion):
    cur, prev = moving_pair(*shape, *motion, seed=shape[1])
    ref = np.asarray(jflow.dense_flow(jnp.asarray(cur), jnp.asarray(prev)))
    out = tflow.dense_flow(t(cur), t(prev))
    assert out.shape == (*shape, 2) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    s10 = tflow.to_s10_5(out).numpy()
    np.testing.assert_array_equal(s10, np.asarray(jflow.to_s10_5(jnp.asarray(ref))))
    # The flow found the motion (x, y) on most pixels.
    assert (np.abs(ref[..., 0] - motion[1]) <= 1).mean() > 0.7
    assert (np.abs(ref[..., 1] - motion[0]) <= 1).mean() > 0.7


def test_to_s10_5_rounds_and_clips_like_jax():
    f = np.array([[0.5 / 32, 1.5 / 32, -2.5 / 32, 1500.0, -1500.0, 3.3]], np.float32)
    np.testing.assert_array_equal(tflow.to_s10_5(t(f)).numpy(),
                                  np.asarray(jflow.to_s10_5(jnp.asarray(f))))


@pytest.mark.parametrize("kw", [{}, dict(levels=3, search=2, refine=1, base_level=0)])
def test_flow_bound_matches_jax(kw):
    assert tflow.flow_bound(**kw) == jflow.flow_bound(**kw)
