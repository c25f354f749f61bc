"""The spatial mode's captured step and System, and the quality and memory
utilities, on the CPU.

  * the body the spatial capture records (``SpatialPipeline.compute_step``
    and the write-back into the static state, runtime/graphs.py), run
    eagerly on the CPU over static buffers, against ``SpatialPipeline.step``
    on every output and state leaf of every frame, the reset frame
    included; the same for the composed body (2 sequences x 2 shards)
    against the eager ``batched_step``;
  * the port's spatial System (2 row shards) with the histogram-peak
    provider at max_in_flight 4 against the JAX System on the same frames,
    every fetched output of every frame and the final state, the provider's
    update from frame 1 landing on frame 5.  The JAX reference is the
    full-frame System, unjitted (a JAX spatial System's three compiles took
    96 s here, the unjitted full frame 36 s with the flow, 18 s without),
    over a module list without the flow and the temporal vote, whose
    spatial seams tests/test_torch_spatial.py holds against JAX and the
    body tests here hold in the captured body;
  * a capture that fails raises ``CaptureError`` out of the System, which
    runs no frame eagerly instead;
  * ``utils/quality`` and the synthetic ground truth against the JAX
    functions on seeded inputs (equal floats and arrays), and
    ``utils/memory`` on the CPU.

32x64 frames, 2 shards, ``reset_iterations`` 4.  Every comparison is
array_equal (NaN equal to NaN; depth against JAX within 2 ulp,
tests/test_torch_slice.py).
"""

import logging

import jax
import numpy as np
import pytest
import torch
from test_torch_faithful import _one_intra_op_thread, eager_jax_relax  # noqa: F401 (fixtures)
from test_torch_slice import _assert_tree_equal

from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.sources.synthetic import SyntheticDataSource as JSource
from cartslam_tpu.utils import quality as jquality
from cartslam_tpu_torch.config import build_pipeline, build_system
from cartslam_tpu_torch.parallel.multiseq import batched_step
from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
from cartslam_tpu_torch.runtime.graphs import (
    CaptureError,
    StaticBuffers,
    _batched_body,
    _sequence_body,
)
from cartslam_tpu_torch.runtime.state import map_tree, stack_trees
from cartslam_tpu_torch.sources import SyntheticDataSource as TSource
from cartslam_tpu_torch.utils import memory
from cartslam_tpu_torch.utils import quality as tquality

H, W, D, FRAMES = 32, 64, 16, 6
SPATIAL = {"mode": "spatial", "devices": 2}
MODULES = [
    {"type": "disparity", "num_disparities": D, "min_disparity": 1},
    {"type": "disparity_derivative"},
    {"type": "depth"},
    {"type": "optflow", "levels": 2, "search": 2, "refine": 1},
    {"type": "superpixels", "block_size": 8, "initial_iterations": 3, "iterations": 2,
     "reset_iterations": 4},
    {"type": "superpixel_disparity_planeseg", "use_temporal_smoothing": True, "max_warp_y": 8,
     "update_interval": 2, "parameter_provider": {"type": "histogram_peak"}},
]
# The System comparison's modules: the flagship's without the flow and the
# temporal vote.
SYSTEM_MODULES = [m for m in MODULES if m["type"] != "optflow"][:-1] + [
    {"type": "superpixel_disparity_planeseg", "update_interval": 2,
     "parameter_provider": {"type": "histogram_peak"}}]
SYSTEM_KEYS = ["disparity", "disparity_derivative", "disparity_derivative_histogram", "depth",
               "superpixels", "superpixels_max_label", "planes"]


def _source(cls, seed=0, frames=FRAMES):
    """At 8 px of disparity the provider finds its peaks on frame 1."""
    return cls(image_size=(H, W), num_frames=frames, seed=seed, max_disparity=0.5 * D,
               baseline=20.0)


def _spatial(modules=MODULES) -> SpatialPipeline:
    pipe, _ = build_pipeline(_source(TSource), modules, device="cpu", parallel=SPATIAL)
    assert isinstance(pipe, SpatialPipeline) and pipe.n == 2
    return pipe


def _numpy(tree):
    return map_tree(lambda t: t.numpy().copy(), tree)


def _assert_same(got, want, where):
    """Equal keys, shapes, dtypes and values, NaN equal to NaN."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, where
    assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), where


def _images(frame):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in frame.items()
            if isinstance(v, np.ndarray)}


def test_captured_body_equals_the_step():
    """The body the spatial capture records, over static buffers (the frame
    loaded as the System loads it, the new state written back in place),
    against SpatialPipeline.step, on every output and state leaf of frames
    1..6: the initial, normal and reset (frame 4) variants."""
    pipe = _spatial()
    keys = frozenset(k for m in pipe.modules for k in m.provides())
    source = _source(TSource)
    first = source.get_next()
    bufs = StaticBuffers(pipe, first)
    params = pipe.init_host_params()
    state = pipe.init_state()
    variants = set()
    frame = first
    for fid in range(1, FRAMES + 1):
        variant = pipe.variant(fid)
        variants.add(variant)
        images = _images(frame)
        bufs.load_frame(images, fid)
        got = _numpy(_sequence_body(pipe, bufs, bufs.state, bufs.frame, variant, keys))
        state, want = pipe.step(state, {**images, "frame_id": fid}, params, variant)
        assert set(got) == keys
        _assert_same(got, _numpy(want), f"frame {fid} outputs")
        _assert_same(_numpy(bufs.state), _numpy(state), f"frame {fid} state")
        frame = source.get_next()
    assert len(variants) == 3


def test_composed_body_equals_the_batched_step():
    """The composed mode's captured body (2 sequences x 2 shards, each
    sequence's spatial body on its own state slice, the outputs stacked)
    against the eager batched_step, frames 1..5 (frame 4 the reset)."""
    pipe = _spatial()
    keys = frozenset(["disparity", "optflow", "superpixels", "planes", "planes_unsmoothed",
                      "disparity_derivative_histogram"])
    sources = [_source(TSource, seed) for seed in (0, 1)]
    frames = [[s.get_next() for s in sources] for _ in range(5)]
    stacked = [{k: np.stack([f[k] for f in fr]) for k in ("left", "right")} for fr in frames]
    bufs = StaticBuffers(pipe, stacked[0], batch=2)
    params = pipe.init_host_params()
    state = stack_trees([pipe.init_state()] * 2)
    for fid, fr in enumerate(stacked, start=1):
        variant = pipe.variant(fid)
        images = _images(fr)
        bufs.load_frame(images, fid)
        got = _numpy(_batched_body(pipe, bufs, variant, keys))
        state, want = batched_step(pipe, state, {**images, "frame_id": fid}, params, variant,
                                   keys=keys)
        _assert_same(got, _numpy(want), f"round {fid} outputs")
        _assert_same(_numpy(bufs.state), _numpy(state), f"round {fid} state")
        assert not np.array_equal(got["disparity"][0], got["disparity"][1])


def _collect(system):
    seen = {}
    n = system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)}))
    assert n == len(seen) and not system.failed_frames
    return seen


def test_spatial_system_matches_jax_system():
    """The port's spatial System (2 row shards, histogram-peak provider, 4
    in flight) against the JAX System, every fetched output of every frame
    and the final state: the provider's update from frame 1 reaches the
    planes on frame 5 in both."""
    jsys = jax_build_system(_source(JSource), SYSTEM_MODULES, extra_fetch_keys=SYSTEM_KEYS,
                            max_in_flight=4)
    jpipe = jsys.pipeline
    jpipe.jitted_step = lambda variant, fetch_keys: jpipe.make_step(variant, fetch_keys)
    want = _collect(jsys)
    system = build_system(_source(TSource), SYSTEM_MODULES, device="cpu", parallel=SPATIAL,
                          extra_fetch_keys=SYSTEM_KEYS, max_in_flight=4)
    assert isinstance(system.pipeline, SpatialPipeline) and not system.captured
    got = _collect(system)
    assert sorted(got) == sorted(want) == list(range(1, FRAMES + 1))
    for fid in got:
        _assert_tree_equal({k: got[fid][k] for k in SYSTEM_KEYS},
                           {k: want[fid][k] for k in SYSTEM_KEYS}, f"frame {fid}")
    _assert_tree_equal(system.final_state, jax.tree.map(np.asarray, jsys.final_state),
                       "final state")
    assert (want[4]["planes"] == 2).all() and not (want[5]["planes"] == 2).all()


def test_failed_capture_raises_and_runs_nothing_eagerly():
    """A spatial System whose capture fails (here: a CPU context made to
    capture) raises CaptureError from run(); no frame reaches on_frame."""
    system = build_system(_source(TSource, frames=2), MODULES, device="cpu", parallel=SPATIAL,
                          max_in_flight=1)
    system.captured = True
    seen = []
    with pytest.raises(CaptureError, match="needs a CUDA device"):
        system.run(on_frame=lambda fid, out: seen.append(fid))
    assert not seen and not system.failed_frames
    with pytest.raises(CaptureError):
        system.pipeline.captured_step(system.pipeline.variant(1), frozenset(["planes"]))


@pytest.mark.parametrize("frame_idx", [0, 1, 7, 31])
def test_ground_truth_matches_jax(frame_idx):
    """The synthetic source's region map and flow, at 96x320 (the quality
    gate's size) and at the test size: equal arrays."""
    for size, md, baseline in (((96, 320), 20.0, 2.0), ((H, W), 0.5 * D, 20.0)):
        kw = dict(image_size=size, num_frames=1, max_disparity=md, baseline=baseline)
        j, t = JSource(**kw), TSource(**kw)
        assert (t.GT_GROUND, t.GT_WALL, t.GT_SKY) == (j.GT_GROUND, j.GT_WALL, j.GT_SKY)
        for name in ("ground_truth_regions", "ground_truth_flow"):
            a, b = getattr(t, name)(frame_idx), getattr(j, name)(frame_idx)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, size)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quality_matches_jax(seed):
    """boundary_recall, undersegmentation_error, flow_epe (with and without a
    mask) and plane_accuracy on seeded label images, flows and plane maps
    against the synthetic truth: equal floats."""
    rng = np.random.default_rng(seed)
    src = TSource(image_size=(96, 320), num_frames=1, max_disparity=20.0, baseline=2.0)
    regions = src.ground_truth_regions(3)
    blocks = rng.integers(0, 400, (96 // 8, 320 // 8))
    sp = np.kron(blocks, np.ones((8, 8), np.int64)).astype(np.int32)
    sp[rng.random(sp.shape) < 0.05] = rng.integers(0, 400)
    flow = (src.ground_truth_flow(3) + rng.normal(0, 0.5, (96, 320, 2))).astype(np.float32)
    mask = rng.random((96, 320)) < 0.7
    planes = rng.integers(0, 3, (96, 320)).astype(np.uint8)
    mapping = {src.GT_GROUND: 0, src.GT_WALL: 1}
    for tol in (0, 2):
        assert tquality.boundary_recall(regions, sp, tol) == jquality.boundary_recall(regions, sp,
                                                                                      tol)
    assert tquality.boundary_recall(np.zeros_like(regions), sp) == 1.0
    assert tquality.undersegmentation_error(regions, sp) == \
        jquality.undersegmentation_error(regions, sp)
    for m in (None, mask):
        assert tquality.flow_epe(flow, src.ground_truth_flow(3), m) == \
            jquality.flow_epe(flow, src.ground_truth_flow(3), m)
    for margin in (0, 4):
        assert tquality.plane_accuracy(planes, regions, mapping, margin) == \
            jquality.plane_accuracy(planes, regions, mapping, margin)


def test_memory_stats_on_the_cpu(caplog):
    """Without a card: one entry, the CPU, and the one log line for a
    backend that reports no memory stats."""
    assert not torch.cuda.is_available()
    assert memory.memory_stats() == [{"device": "cpu"}]
    with caplog.at_level(logging.INFO, logger="cart.memory"):
        memory.report_memory_usage()
    assert caplog.messages == ["cpu: backend reports no memory stats"]
