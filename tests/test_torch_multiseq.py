"""The port's multi-sequence modes against the JAX package, on the CPU.

  * ``build_system`` with ``{"mode": "multiseq", "batch": 3}`` (B odd, so a
    wrong sequence index shows) over the flagship-like module list of
    tests/test_torch_system.py (histogram-peak provider updating every 2
    rounds, so an update from the batch-summed histogram lands inside the
    run) and the BEV visualization, against the JAX MultiSeqSystem: every
    fetched output of every sequence and round, the final state, the
    provider's running histogram and the visualization's image (sequence 0),
    at max_in_flight 1 and 4;
  * a checkpoint written by the JAX MultiSeqSystem at round 3, resumed by the
    port's, against the uninterrupted JAX run; the port's checkpoint read by
    the JAX package;
  * a failed round (a hung fetch raises DataNotAvailableException, a failing
    one its own error) recovers and the loop runs on; grayscale frames.

The composed mode and the CLI are in tests/test_torch_multiseq_composed.py
(a file of their own, so the two files' JAX runs go to two test workers).

The JAX MultiSeqSystem runs its step unjitted (an unjitted ``jax.vmap`` of
``Pipeline.make_step``, with the eager relax of tests/test_torch_faithful.py:
jitted XLA:CPU contracts FMAs; ROADMAP.md, divergences).  Every comparison is
array_equal (depth within 2 ulp, tests/test_torch_slice.py).
"""

import logging
import time

import jax
import numpy as np
import pytest
from test_torch_faithful import _one_intra_op_thread, eager_jax_relax  # noqa: F401 (fixtures)
from test_torch_slice import _assert_tree_equal

from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.parallel.system import MultiSeqSystem as JMultiSeqSystem
from cartslam_tpu.runtime.checkpoint import load_checkpoint as jax_load_checkpoint
from cartslam_tpu.sources.synthetic import SyntheticDataSource as JSource
from cartslam_tpu.viz.ui import ImageStore as JImageStore
from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.parallel.system import MultiSeqSystem
from cartslam_tpu_torch.sources import SyntheticDataSource as TSource
from cartslam_tpu_torch.viz.ui import ImageStore

H, W, D, B, ROUNDS, CKPT_AT = 64, 128, 32, 3, 5, 3
KEYS = ["disparity", "disparity_derivative", "disparity_derivative_histogram", "depth",
        "optflow", "superpixels", "superpixels_max_label", "planes", "planes_unsmoothed"]
MODULES = [
    {"type": "superpixels", "initial_iterations": 3, "iterations": 2, "block_size": 8,
     "reset_iterations": 4},
    {"type": "optflow", "levels": 3, "search": 2, "refine": 1},
    {"type": "disparity", "num_disparities": D, "min_disparity": 4, "smoothing_radius": 2,
     "smoothing_iterations": 1},
    {"type": "disparity_derivative"},
    {"type": "depth"},
    {"type": "superpixel_disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
     "update_interval": 2, "use_temporal_smoothing": True},
    {"type": "bev_planeseg_visualization"},
]
BEV = "PlaneSegmentationBEVVisualization"


def _sources(cls, rounds=ROUNDS):
    """B synthetic sequences, seeds 0..B-1 (the seeds `_replicate_sources`
    gives a synthetic config), at tests/test_torch_system.py's disparity."""
    return [cls(image_size=(H, W), num_frames=rounds, seed=i, max_disparity=0.5 * D,
                baseline=20.0) for i in range(B)]


def _collect(system):
    seen = {}
    n = system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)}))
    assert n == B * len(seen) and not system.failed_frames
    return seen


def _jax_system(rounds=ROUNDS, **kw):
    """The JAX MultiSeqSystem on one device, its step an unjitted vmap."""
    single = jax_build_system(_sources(JSource, rounds)[0], MODULES)
    system = JMultiSeqSystem(_sources(JSource, rounds), single.pipeline, single.host_modules,
                             devices=jax.devices()[:1], extra_fetch_keys=KEYS, **kw)
    pipe = system.pipeline
    system._jitted = lambda variant, fetch_keys: jax.vmap(
        pipe.make_step(variant, fetch_keys), in_axes=(0, 0, None))
    return system


def _port_system(rounds=ROUNDS, **kw):
    first, *_ = sources = _sources(TSource, rounds)
    return build_system(first, MODULES, device="cpu", extra_fetch_keys=KEYS,
                        parallel={"mode": "multiseq", "batch": B, "sources": sources}, **kw)


def _provider_state(system):
    return next(m for m in system.pipeline.modules if m.host_fetch_reduce()).host_state()


def _assert_rounds_equal(got: dict, want: dict, first: int = 1):
    assert sorted(got) == list(range(first, ROUNDS + 1)) == sorted(want)[first - 1:]
    for fid in got:
        for k in KEYS:
            assert got[fid][k].shape[0] == B, k
        _assert_tree_equal({k: got[fid][k] for k in KEYS}, {k: want[fid][k] for k in KEYS},
                           f"round {fid}")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX MultiSeqSystem at max_in_flight 1 and 4 (every round's fetched
    outputs, the final state, the provider's host state, the BEV image), and
    the checkpoint the first run wrote at round 3 (at max_in_flight 1 its
    drain before the write changes nothing)."""
    runs = {}
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "state.npz")
    for depth in (1, 4):
        sink = JImageStore()
        kw = dict(checkpoint_path=ckpt, checkpoint_interval=CKPT_AT) if depth == 1 else {}
        system = _jax_system(max_in_flight=depth, image_sink=sink, **kw)
        seen = _collect(system)
        runs[depth] = (seen, jax.tree.map(np.asarray, system.final_state),
                       _provider_state(system), sink.snapshot()[BEV])
    return runs, ckpt


@pytest.mark.parametrize("max_in_flight", [1, 4])
def test_multiseq_matches_jax(jax_runs, max_in_flight):
    want, want_state, want_host, want_bev = jax_runs[0][max_in_flight]
    sink = ImageStore()
    system = _port_system(max_in_flight=max_in_flight, image_sink=sink)
    assert isinstance(system, MultiSeqSystem) and not system.captured
    assert system.batch == B and system.device.type == "cpu"
    got = _collect(system)
    _assert_rounds_equal(got, want)
    _assert_tree_equal(system.final_state, want_state, "final state")
    # The provider summed the B histograms: its running histogram and ranges
    # are JAX's, and an update reached the planes inside the run.
    _assert_tree_equal(_provider_state(system), want_host, "provider host state")
    fid, img = sink.snapshot()[BEV]
    assert fid == want_bev[0] == ROUNDS
    np.testing.assert_array_equal(img, want_bev[1])
    first = 1 + max_in_flight
    assert (want[first - 1]["planes"] == 2).all() and not (want[first]["planes"] == 2).all()
    # The sequences differ (a wrong sequence index would show above).
    assert not np.array_equal(got[ROUNDS]["disparity"][0], got[ROUNDS]["disparity"][1])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multiseq_resume_from_checkpoint(jax_runs, tmp_path, writer):
    (want, *_), jax_ckpt = jax_runs[0][1], jax_runs[1]
    ckpt = jax_ckpt
    if writer == "port":
        ckpt = str(tmp_path / "port.npz")
        _collect(_port_system(rounds=CKPT_AT, max_in_flight=1, checkpoint_path=ckpt,
                              checkpoint_interval=CKPT_AT))
        # The JAX package reads the port's checkpoint: the batched layout,
        # equal leaves and host state.
        init = jax.tree.map(lambda x: np.stack([x] * B),
                            _jax_system().pipeline.init_state())
        state, fid, host = jax_load_checkpoint(ckpt, init)
        jstate, jfid, jhost = jax_load_checkpoint(jax_ckpt, init)
        assert fid == jfid == CKPT_AT
        _assert_tree_equal(jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, jstate),
                           "checkpoint state")
        _assert_tree_equal(host, jhost, "checkpoint host state")
    resumed = _port_system(max_in_flight=1, resume_from=ckpt)
    _assert_rounds_equal(_collect(resumed), want, CKPT_AT + 1)


def _small_system(**kw):
    """The JAX fault tests' system: 8 sequences of 32x64, 6 rounds, with the
    flow's carried state."""
    return build_system({"type": "synthetic", "image_size": [32, 64], "num_frames": 6},
                        [{"type": "disparity", "num_disparities": 16, "min_disparity": 0},
                         {"type": "optflow", "levels": 2, "search": 2, "refine": 1}],
                        parallel={"mode": "multiseq", "batch": 8}, device="cpu",
                        extra_fetch_keys=["disparity"], **kw)


@pytest.mark.parametrize("fault", ["hang", "raise"])
def test_multiseq_failed_round_recovers(monkeypatch, caplog, fault):
    """A failed round logs and the loop runs on to the end of the sequences,
    with recovery from the snapshot; a hung fetch raises
    DataNotAvailableException after data_timeout (tests/test_parallel.py's
    two multiseq fault tests)."""
    system = _small_system(data_timeout=0.5, snapshot_interval=2, max_in_flight=2)
    orig = system._fetch_with_timeout
    calls = {"n": 0}

    def faulty(staged):
        calls["n"] += 1
        if calls["n"] == 2:
            if fault == "hang":
                time.sleep(3.0)
            else:
                raise RuntimeError("injected device failure")
        return orig(staged)

    monkeypatch.setattr(system, "_fetch_with_timeout", faulty)
    seen = {}
    with caplog.at_level(logging.INFO, logger="cart.system"):
        n = system.run(on_frame=lambda fid, out: seen.update({fid: out}))
    assert system.failed_frames == [2]
    assert ("DataNotAvailableException" in caplog.text) == (fault == "hang")
    assert "recovered pipeline state from snapshot" in caplog.text
    assert n >= 3 * 8 and n == 8 * len(seen) and max(seen) == 6
    assert seen[6]["disparity"].shape == (8, 32, 64)


def test_multiseq_grayscale():
    """grayscale + multiseq: the frames are converted at stacking, so the
    1-channel modules see 1-channel frames (tests/test_parallel.py)."""
    system = build_system({"type": "synthetic", "image_size": [32, 64], "num_frames": 3},
                          [{"type": "disparity", "num_disparities": 16, "min_disparity": 0}],
                          grayscale=True, parallel={"mode": "multiseq", "batch": 8},
                          device="cpu", extra_fetch_keys=["disparity"])
    assert system.run() == 3 * 8
    assert not system.failed_frames


def test_capture_holds_the_cyclic_collector():
    """A collection during a capture could destroy an unreachable CUDA graph
    of an earlier System, which invalidates the capture (found on the card
    with the multiseq capture after earlier phases): the capture block runs
    with the collector off, and restores it."""
    import gc

    from cartslam_tpu_torch.runtime.graphs import _no_gc

    assert gc.isenabled()
    with _no_gc():
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(RuntimeError), _no_gc():
        raise RuntimeError("a failed capture")
    assert gc.isenabled()
