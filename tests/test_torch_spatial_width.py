"""The port's width-sharded stencils (parallel/spatial.py) against the JAX
functions on the 8-device virtual CPU mesh, at tests/test_parallel.py's
shapes and seeds: the derivative with its psum'd histogram, the
interpolation with a halo exchange per iteration, and the classification;
every output array_equal.  The port's shards are the 8 threads of a
ShardGroup on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cartslam_tpu.parallel import spatial as jspatial
from cartslam_tpu_torch.parallel import spatial as tspatial
from cartslam_tpu_torch.parallel.group import ShardGroup

N = 8


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < N:
        pytest.skip("needs 8 virtual devices")
    return Mesh(np.array(devs[:N]), ("spatial",))


@pytest.fixture(scope="module")
def group():
    return ShardGroup(N, ["cpu"] * N)


def _width_sharded(mesh, x):
    return jax.device_put(jnp.array(x), NamedSharding(mesh, P(None, "spatial")))


def test_sharded_derivative(mesh, group):
    rng = np.random.RandomState(0)
    d = rng.randint(60, 2000, (32, 128)).astype(np.int16)
    d[rng.rand(32, 128) < 0.1] = -32768
    want_deriv, want_hist = jspatial.sharded_derivative(mesh)(_width_sharded(mesh, d))
    deriv, hist = tspatial.sharded_derivative(group)(torch.from_numpy(d))
    np.testing.assert_array_equal(deriv.numpy(), np.asarray(want_deriv))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want_hist))
    assert hist.sum() > 0


def test_sharded_interpolate(mesh, group):
    rng = np.random.RandomState(2)
    d = (rng.randint(4, 60, (24, 128)) * 16).astype(np.int16)
    d[rng.rand(24, 128) < 0.3] = -32768
    kw = dict(radius=3, iterations=2, min_disparity=16, max_disparity=128)
    want = jspatial.sharded_interpolate(mesh, **kw)(_width_sharded(mesh, d))
    got = tspatial.sharded_interpolate(group, **kw)(torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_classify(mesh, group):
    rng = np.random.RandomState(1)
    deriv = rng.randint(-100, 100, (16, 64)).astype(np.int16)
    ranges = np.array([[5, 50], [-10, 5]], np.int32)
    want = jspatial.sharded_classify(mesh)(_width_sharded(mesh, deriv), jnp.array(ranges))
    got = tspatial.sharded_classify(group)(torch.from_numpy(deriv), torch.from_numpy(ranges))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_width_must_split():
    with pytest.raises(ValueError, match="does not split"):
        tspatial.sharded_classify(ShardGroup(3, ["cpu"] * 3))(
            torch.zeros(4, 64, dtype=torch.int16), torch.zeros(2, 2, dtype=torch.int32))
