"""The port's System loop, checkpoints, host modules and CLI against the
JAX package, on the CPU.

  * ``build_system`` of a flagship-like module list (histogram-peak
    provider updating every 2 frames, so updates land inside the run, and
    the two plane-segmentation visualizations) against the JAX System,
    every fetched output of every frame and the final state, at
    max_in_flight 1 and 4.  At 4 the JAX System applies frame t's provider
    update from frame t + 4; the port's synchronous ``runtime/loop.run``
    applies it from frame t + 1 and so differs, while the port's System
    does not;
  * a checkpoint written by the JAX System at frame 3, resumed by the
    port's System, against the uninterrupted JAX run; the port's own
    round trip, and JAX reading the port's checkpoint;
  * ``get_run_by_id`` retention, the fetch watchdog (a hung or failing
    fetch: a failed frame, recovery from the snapshot), module timing rows;
  * every ported visualization module's render against the JAX module's on
    the same fetched arrays;
  * the CLI on the flagship's module config.

The JAX steps run unjitted, with the eager relax of
tests/test_torch_faithful.py (jitted XLA:CPU contracts FMAs; ROADMAP.md,
divergences).  Every comparison is array_equal (depth within 2 ulp).
"""

import csv
import functools
import logging
import pathlib
import time

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from test_torch_faithful import _one_intra_op_thread, eager_jax_relax  # noqa: F401 (fixtures)
from test_torch_slice import _assert_tree_equal

from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.runtime.checkpoint import load_checkpoint as jax_load_checkpoint
from cartslam_tpu.sources.synthetic import SyntheticDataSource as JSource
from cartslam_tpu.utils.plane_params import PlaneParameters as JParams
from cartslam_tpu.viz import host_modules as jvm
from cartslam_tpu_torch.__main__ import main as torch_main
from cartslam_tpu_torch.config import build_pipeline, build_system
from cartslam_tpu_torch.runtime import run
from cartslam_tpu_torch.runtime.checkpoint import treedef_str
from cartslam_tpu_torch.runtime.timing import TimingWriter
from cartslam_tpu_torch.sources import SyntheticDataSource as TSource
from cartslam_tpu_torch.utils.plane_params import PlaneParameters as TParams
from cartslam_tpu_torch.viz import host_modules as tvm
from cartslam_tpu_torch.viz import ui
from cartslam_tpu_torch.viz.ui import SampleSink

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W, D, FRAMES, CKPT_AT = 64, 128, 32, 6, 3
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
    {"type": "disparity_planeseg_visualization", "show_histogram": False},
    {"type": "bev_planeseg_visualization"},
]


def _source(cls, frames=FRAMES):
    """At 16 px of disparity the histogram-peak provider already finds its
    peaks on frame 1, so its update lands on frame 2 (max_in_flight 1) and
    on frame 5 (max_in_flight 4)."""
    return cls(image_size=(H, W), num_frames=frames, seed=0, max_disparity=0.5 * D,
               baseline=20.0)


def _collect(system):
    seen = {}
    n = system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)}))
    assert n == len(seen) and not system.failed_frames
    return seen


def _jax_system(**kw):
    """The JAX System with its step unjitted (as tests/test_torch_pixel_
    planeseg.py runs it)."""
    system = jax_build_system(_source(JSource, kw.pop("frames", FRAMES)), MODULES,
                              extra_fetch_keys=KEYS, **kw)
    pipe = system.pipeline
    pipe.jitted_step = lambda variant, fetch_keys: pipe.make_step(variant, fetch_keys)
    return system


def _port_system(**kw):
    return build_system(_source(TSource, kw.pop("frames", FRAMES)), MODULES,
                        extra_fetch_keys=KEYS, device="cpu", **kw)


def _assert_runs_equal(got: dict, want: dict, first: int = 1):
    assert sorted(got) == list(range(first, FRAMES + 1)) == sorted(want)[first - 1:]
    for fid in got:
        _assert_tree_equal({k: got[fid][k] for k in KEYS}, {k: want[fid][k] for k in KEYS},
                           f"frame {fid}")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX System at max_in_flight 1 and 4 (every frame's fetched
    outputs and the final state), and a checkpoint it wrote at frame 3."""
    runs = {}
    for depth in (1, 4):
        system = _jax_system(max_in_flight=depth)
        runs[depth] = (_collect(system), jax.tree.map(np.asarray, system.final_state))
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "state.npz")
    _collect(_jax_system(max_in_flight=1, frames=CKPT_AT, checkpoint_path=ckpt,
                         checkpoint_interval=CKPT_AT))
    return runs, ckpt


@pytest.mark.parametrize("max_in_flight", [1, 4])
def test_system_matches_jax_system(jax_runs, max_in_flight):
    want, want_state = jax_runs[0][max_in_flight]
    system = _port_system(max_in_flight=max_in_flight)
    assert not system.captured  # a CPU context runs the eager step
    got = _collect(system)
    _assert_runs_equal(got, want)
    _assert_tree_equal(system.final_state, want_state, "final state")
    # The provider's update on frame 1 reached the planes inside the run.
    first = 1 + max_in_flight
    assert (want[first - 1]["planes"] == 2).all() and not (want[first]["planes"] == 2).all()


def test_loop_lagged_the_params_of_the_jax_system(jax_runs):
    """The repaired fault: the synchronous loop applies frame t's provider
    update from frame t + 1, the JAX System at max_in_flight=4 from frame
    t + 4, so their planes differ on frames 2-4; the loop is the System at
    max_in_flight=1."""
    (want1, _), (want4, _) = jax_runs[0][1], jax_runs[0][4]
    pipe, source = build_pipeline(_source(TSource), MODULES[:-2], device="cpu")
    seen = {}
    run(pipe, source, on_frame=lambda fid, out: seen.update(
        {fid: {k: v.numpy() for k, v in out.items()}}))
    _assert_runs_equal(seen, want1)
    differ = [fid for fid in seen if not np.array_equal(seen[fid]["planes"], want4[fid]["planes"])]
    assert differ and min(differ) == 2, differ


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_from_checkpoint(jax_runs, tmp_path, writer):
    (want, _), jax_ckpt = jax_runs[0][1], jax_runs[1]
    ckpt = jax_ckpt
    if writer == "port":
        ckpt = str(tmp_path / "port.npz")
        first = _port_system(max_in_flight=1, frames=CKPT_AT, checkpoint_path=ckpt,
                             checkpoint_interval=CKPT_AT)
        _collect(first)
        # The JAX package reads the port's checkpoint: the same layout and
        # treedef, equal leaves.
        jpipe = _jax_system().pipeline
        state, fid, host = jax_load_checkpoint(ckpt, jpipe.init_state())
        jstate, jfid, jhost = jax_load_checkpoint(jax_ckpt, jpipe.init_state())
        assert fid == jfid == CKPT_AT
        _assert_tree_equal(jax.tree.map(np.asarray, state), jax.tree.map(np.asarray, jstate),
                           "checkpoint state")
        _assert_tree_equal(host, jhost, "checkpoint host state")
    resumed = _port_system(max_in_flight=1, resume_from=ckpt)
    _assert_runs_equal(_collect(resumed), want, CKPT_AT + 1)


def test_checkpoint_structure_is_checked(tmp_path):
    from cartslam_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint

    path = str(tmp_path / "ck.npz")
    tree = {"b": {"y": np.ones(3, np.int32)}, "a": {"x": np.zeros((2, 2), np.uint8), "e": {}}}
    save_checkpoint(path, tree, 5, {"M": {"h": np.arange(3)}})
    assert treedef_str(tree) == str(jax.tree.flatten(tree)[1])
    state, fid, host = load_checkpoint(path, tree)
    assert fid == 5 and state["b"]["y"].sum() == 3 and host["M"]["h"].tolist() == [0, 1, 2]
    for bad, match in (({**tree, "c": {}}, "different state structure"),
                       ({"b": {"y": np.ones(4, np.int32)}, "a": tree["a"]}, "leaf 1")):
        with pytest.raises(ValueError, match=match):
            load_checkpoint(path, bad)


def test_spatial_mode_runs_through_the_system():
    """A config's spatial block goes through the System (the eager step):
    2 row shards equal to the full frame with the 'select' warp, every
    fetched output of every frame."""
    src = {"type": "synthetic", "image_size": [32, 64], "num_frames": 3}
    mods = [{"type": "disparity", "num_disparities": 16, "min_disparity": 1},
            {"type": "disparity_derivative"},
            {"type": "optflow", "levels": 2, "search": 2, "refine": 1},
            {"type": "superpixels", "block_size": 8, "initial_iterations": 3, "iterations": 2},
            {"type": "superpixel_disparity_planeseg", "use_temporal_smoothing": True,
             "max_warp_y": 8, "parameter_provider": {
                 "type": "static", "horizontal_range_min": 3, "horizontal_range_max": 40,
                 "vertical_range_min": -6, "vertical_range_max": 3}}]
    keys = ["disparity", "optflow", "superpixels", "planes", "planes_unsmoothed"]
    spatial = build_system(dict(src), mods, device="cpu", extra_fetch_keys=keys,
                           parallel={"mode": "spatial", "devices": 2})
    assert type(spatial.pipeline).__name__ == "SpatialPipeline" and not spatial.captured
    full = build_system(dict(src), mods[:-1] + [dict(mods[-1], warp_mode="select")],
                        device="cpu", extra_fetch_keys=keys)
    got, want = _collect(spatial), _collect(full)
    assert sorted(got) == [1, 2, 3]
    for fid in got:
        _assert_tree_equal(got[fid], want[fid], f"frame {fid}")


def test_run_retention_window():
    system = build_system({"type": "synthetic", "image_size": [32, 64], "num_frames": 6},
                          [{"type": "disparity", "num_disparities": 16, "min_disparity": 0}],
                          extra_fetch_keys=["disparity"], run_retention=4, device="cpu")
    assert system.run() == 6
    assert system.get_run_by_id(6)["disparity"].shape == (32, 64)
    assert system.get_run_by_id(3)["disparity"].shape == (32, 64)
    with pytest.raises(KeyError):
        system.get_run_by_id(1)  # evicted: outside the retention window


@pytest.mark.parametrize("fault", ["hang", "raise"])
def test_failed_fetch_recovers_from_snapshot(monkeypatch, caplog, fault):
    """A fetch that hangs past data_timeout raises DataNotAvailableException
    (a failing one its own error): the frame is recorded as failed, the
    state comes back from the last snapshot and the loop runs to the end."""
    system = build_system({"type": "synthetic", "image_size": [32, 64], "num_frames": 8},
                          [{"type": "disparity", "num_disparities": 16, "min_disparity": 0},
                           {"type": "optflow", "levels": 2, "search": 2, "refine": 1}],
                          extra_fetch_keys=["disparity"], data_timeout=0.5,
                          snapshot_interval=2, max_in_flight=2, device="cpu")
    orig = system._fetch_with_timeout
    calls = {"n": 0}

    def faulty(staged):
        calls["n"] += 1
        if calls["n"] == 5:
            if fault == "hang":
                time.sleep(3.0)
            else:
                raise RuntimeError("injected device failure")
        return orig(staged)

    monkeypatch.setattr(system, "_fetch_with_timeout", faulty)
    seen = {}
    with caplog.at_level(logging.INFO, logger="cart.system"):
        n = system.run(on_frame=lambda fid, out: seen.update({fid: out}))
    assert system.failed_frames == [5]
    text = caplog.text
    assert ("DataNotAvailableException" in text) == (fault == "hang")
    assert "recovered pipeline state from snapshot" in text
    assert max(seen) == 8 and n == len(seen) and 5 not in seen


def test_module_timing_rows(tmp_path):
    tw = TimingWriter(directory=str(tmp_path), enabled=True)
    system = build_system({"type": "synthetic", "image_size": [32, 64], "num_frames": 3},
                          [{"type": "disparity", "num_disparities": 16, "min_disparity": 0},
                           {"type": "disparity_derivative"}],
                          timing=tw, module_timing=True, device="cpu")
    assert system.run() == 3
    tw.close()
    text = next(tmp_path.glob("timing-*.csv")).read_text().strip().splitlines()
    assert text[0] == "name;run_id;time_init;time_start;time_end;duration_ms"
    rows = [r.split(";") for r in text[1:]]
    for name in ("ImageDisparity", "ImageDisparityDerivative", "frame"):
        assert sorted(int(r[1]) for r in rows if r[0] == name) == [1, 2, 3], name
    assert [r[0] for r in rows].count("system") == 1
    for r in rows:
        assert float(r[2]) <= float(r[3]) <= float(r[4])


# ---------------------------------------------------------- host modules

def _fetched():
    """Fetched arrays as a 64x128 run gives them, made from a seed."""
    rng = np.random.default_rng(5)
    disp = rng.integers(0, 60 * 16, (H, W)).astype(np.int16)
    disp[rng.random((H, W)) < 0.1] = -32768
    deriv = rng.integers(-40, 40, (H, W, 2)).astype(np.int16)
    deriv[rng.random((H, W)) < 0.1] = -32768
    depth = np.stack([rng.uniform(-12, 12, (H, W)), rng.uniform(-2, 2, (H, W)),
                      rng.uniform(-1, 25, (H, W))], axis=-1).astype(np.float32)
    labels = (np.arange(H)[:, None] // 8 * 16 + np.arange(W)[None, :] // 8).astype(np.int32)
    labels[rng.random((H, W)) < 0.05] += 1
    return {"disparity": disp, "disparity_derivative": deriv, "depth": depth,
            "optflow": rng.integers(-200, 200, (H, W, 2)).astype(np.int16),
            "superpixels": labels,
            "planes": rng.integers(0, 3, (H, W)).astype(np.uint8),
            "planes_unsmoothed": rng.integers(0, 3, (H, W)).astype(np.uint8)}


@pytest.mark.parametrize("name,kw", [
    ("DisparityVisualization", {}), ("DerivativeVisualization", {}),
    ("DepthVisualization", {}), ("OpticalFlowVisualization", {"points": 7}),
    ("SuperPixelVisualization", {}), ("PlaneSegmentationVisualization", {}),
    ("BEVVisualization", {}),
])
@pytest.mark.parametrize("gray", [False, True], ids=["bgr", "gray"])
def test_visualization_matches_jax(name, kw, gray):
    rng = np.random.default_rng(9)
    frames = [{"left": rng.integers(0, 256, (H, W) if gray else (H, W, 3)).astype(np.uint8)}
              for _ in range(2)]
    fetched = _fetched()
    hist = np.random.default_rng(2).integers(0, 500, 256)
    out = {}
    for pkg, vm, params in (("jax", jvm, JParams), ("port", tvm, TParams)):
        mod = getattr(vm, name)(**kw)
        globals_ = {"disp_derivative_histogram": hist,
                    "plane_parameters": params((-20, 3), (5, 60), -8, 32)}
        out[pkg] = [mod.render(None, fid, frames[fid - 1], fetched, globals_)
                    for fid in (1, 2)]
    for fid, (a, b) in enumerate(zip(out["port"], out["jax"]), start=1):
        if b is None:
            assert a is None, f"frame {fid}"
            continue
        a, b = (a, b) if isinstance(b, dict) else ({"": a}, {"": b})
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == np.uint8 and a[k].ndim == 3
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} frame {fid} {k}")
    assert out["port"][1] is not None


def test_sample_sink_writes_the_last_frame_on_close(tmp_path):
    sink = SampleSink(directory=str(tmp_path), interval=2, write_last_on_close=True)
    img = np.full((4, 6, 3), 7, np.uint8)
    for fid in (1, 2, 3):
        sink.set_image_if_later("plane seg", img, fid)
    sink.set_image_if_later("bev", img, 2)
    sink.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bev-000002.png", "plane_seg-000002.png", "plane_seg-000003.png"]


def test_cli_runs_the_flagship_module_config(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # The CLI's sink writes frames with frame_id % interval == 0 (30): an
    # interval of 3 puts frame 3 of this short run under that rule.
    monkeypatch.setattr(ui, "SampleSink", functools.partial(SampleSink, interval=3))
    assert torch_main([str(REPO / "configs" / "sources" / "synthetic.json"),
                       str(REPO / "configs" / "modules" / "kitti-planeseg.json"),
                       "--device", "cpu", "--max-frames", "3", "--timing",
                       "--save-samples"]) == 0
    with open(next((tmp_path / "timing").glob("timing-*.csv"))) as f:
        rows = list(csv.reader(f, delimiter=";"))
    assert rows[0] == ["name", "run_id", "time_init", "time_start", "time_end", "duration_ms"]
    assert sorted(int(r[1]) for r in rows[1:] if r[0] == "frame") == [1, 2, 3]
    samples = sorted(p.name for p in (tmp_path / "samples").iterdir())
    assert samples == ["PlaneSegmentationBEVVisualization-000003.png",
                       "Plane_Segmentation-000003.png"]


def test_build_system_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system({"type": "synthetic", "image_size": [16, 32]}, [])


# ------------------------------------------------ the step body on the host

_HOST_READS = {"nonzero", "_local_scalar_dense", "bincount", "masked_select", "_unique2",
               "unique_dim", "unique_consecutive", "equal", "is_nonzero", "lift_fresh"}


class _HostReads(TorchDispatchMode):
    """Records the ops that read a tensor back to the host or make one from
    host data (on a card: a synchronisation or a pageable copy, which a
    captured step cannot do): the ops of _HOST_READS, indexing by a bool
    mask, and a repeat_interleave with tensor repeats."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name == "index" and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1])
        if name in _HOST_READS or bool_index or func is torch.ops.aten.repeat_interleave.Tensor:
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


def _unwatched(fn):
    """fn run outside the dispatch mode: the kernels' plain versions, which
    stand in for the CUDA kernels on the CPU only."""

    def call(*args, **kw):
        with _disable_current_modes():
            return fn(*args, **kw)
    return call


@pytest.mark.parametrize("temporal_mode", ["carried", "faithful"])
def test_step_body_reads_nothing_back(temporal_mode, monkeypatch):
    """Pipeline.compute_step, the body that the System captures into a CUDA
    graph on the card, on its initial, normal and reset variants: no op in
    it (the kernels' plain versions aside) reads a tensor back to the host
    or copies host data in."""
    from cartslam_tpu_torch.kernels import relax as krelax
    from cartslam_tpu_torch.kernels import tally as ktally
    from cartslam_tpu_torch.ops import stereo
    from cartslam_tpu_torch.runtime.loop import frame_to_device

    for mod, names in ((krelax, ("relax_sweeps_plain", "relax_phase_plain")),
                       (ktally, ("moment_tally_plain", "vote_tally_plain", "label_tally_plain")),
                       (stereo, ("sgm_from_census_plain",))):
        for name in names:
            monkeypatch.setattr(mod, name, _unwatched(getattr(mod, name)))

    mods = [dict(m, temporal_mode=temporal_mode) if m["type"].endswith("planeseg")
            else dict(m, stats_refresh="phase", relax_phases=2)
            if m["type"] == "superpixels" and temporal_mode == "faithful" else m
            for m in MODULES[:-2]]
    pipe, source = build_pipeline(_source(TSource, 4), mods, device="cpu")
    state = pipe.init_state()
    params = pipe.device_params(pipe.init_host_params())
    for fid in range(1, 5):
        frame, _ = pipe.prepare(frame_to_device(source.get_next(), fid, "cpu"), params)
        with _HostReads() as reads:
            state, _ = pipe.compute_step(state, frame, params, pipe.variant(fid))
        assert not reads.found, (fid, pipe.variant(fid), reads.found)
