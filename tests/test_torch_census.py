"""The census wrapper (kernels/census.py) against the JAX census, on the CPU.

On CPU tensors ``census_transform`` and ``census_pair`` run the plain
version (ops/stereo.census_transform); the card kernel is held to it by
chip_smoke.py.  The outputs are integers, so they must be equal.  The shapes
cross the card kernel's 16 x 64 tile and its 3-row, 4-column window edges.
"""

import jax
import numpy as np
import pytest
import torch

from cartslam_tpu.ops import stereo as jstereo
from cartslam_tpu_torch.kernels import census as kcensus

SHAPES = [(1, 1), (1, 9), (7, 1), (3, 5), (7, 9), (33, 65), (64, 128)]
_jax_census = jax.jit(jstereo.census_transform)


def image(kind: str, shape, seed: int) -> np.ndarray:
    if kind == "random":
        return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    if kind == "checkerboard":
        ys, xs = np.indices(shape)
        return ((ys + xs) % 2 * 255).astype(np.uint8)
    return np.full(shape, {"constant": 77, "zeros": 0, "full": 255}[kind], np.uint8)


def assert_words_equal(words, gray):
    want = _jax_census(gray)
    assert len(words) == 2
    for got, ref in zip(words, want):
        assert got.dtype == torch.int32 and tuple(got.shape) == gray.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["random", "constant", "zeros", "full", "checkerboard"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_census_matches_jax(shape, kind):
    """census_transform and census_pair equal the JAX census, and each call
    runs the plain version once."""
    left = image(kind, shape, seed=shape[0] * 131 + shape[1])
    right = image("random", shape, seed=shape[0] + 7 * shape[1])
    before = kcensus.COUNTER.plain_calls
    assert_words_equal(kcensus.census_transform(torch.from_numpy(left)), left)
    assert kcensus.COUNTER.plain_calls == before + 1
    wl, wr = kcensus.census_pair(torch.from_numpy(left), torch.from_numpy(right))
    assert kcensus.COUNTER.plain_calls == before + 2
    assert kcensus.COUNTER.launches == 0
    assert_words_equal(wl, left)
    assert_words_equal(wr, right)


_U8 = torch.zeros((4, 6), dtype=torch.uint8)


@pytest.mark.parametrize("images", [
    (torch.zeros((4, 6), dtype=torch.int32),),
    (torch.zeros((4, 6), dtype=torch.float32), _U8),
    (torch.zeros((2, 4, 6), dtype=torch.uint8),),
    (torch.zeros(6, dtype=torch.uint8),),
    (torch.zeros((0, 6), dtype=torch.uint8),),
    (_U8, torch.zeros((4, 7), dtype=torch.uint8)),
    (_U8, torch.zeros((4, 6), dtype=torch.int16)),
], ids=["int32", "float32-pair", "3-d", "1-d", "empty", "mismatched-pair", "int16-right"])
def test_census_refuses(images):
    before = kcensus.COUNTER.plain_calls
    with pytest.raises(ValueError, match="census"):
        if len(images) == 1:
            kcensus.census_transform(*images)
        else:
            kcensus.census_pair(*images)
    assert kcensus.COUNTER.plain_calls == before
