"""The port's non-temporal plane-segmentation slice against the JAX pipeline.

Both packages run the same five modules (disparity -> derivative -> depth ->
superpixels -> superpixel plane segmentation) on the same synthetic frames,
on the CPU, with the host step (histogram-peak provider) on both sides.
Every output, all state and the host params must be equal each frame
(depth: within 2 ulp, inf/nan at the same positions).  The geometry is cut
to 64x128 with 32 disparities, block 8, 3/2 sweeps, a reset every 4 frames
and a provider update every 3, so 6 frames cross the initial, normal,
provider-update and reset variants.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from cartslam_tpu import models as jm
from cartslam_tpu.runtime.module import PipelineContext as JContext
from cartslam_tpu.runtime.pipeline import Pipeline as JPipeline
from cartslam_tpu.sources.synthetic import SyntheticDataSource
from cartslam_tpu.utils.plane_params import HistogramPeakPlaneParameterProvider as JProvider
from cartslam_tpu_torch import models as tm
from cartslam_tpu_torch.__main__ import main as torch_main
from cartslam_tpu_torch.config import (build_pipeline, build_system, read_config,
                                       read_system_config)
from cartslam_tpu_torch.kernels import build as kbuild
from cartslam_tpu_torch.parallel.system import MultiSeqSystem, SpatialMultiSeqSystem
from cartslam_tpu_torch.runtime import (
    Pipeline,
    PipelineContext,
    PipelineError,
    host_step,
    state_from_reference,
    state_to_numpy,
)
from cartslam_tpu_torch.runtime.loop import frame_to_device
from cartslam_tpu_torch.sources import SyntheticDataSource as TSyntheticDataSource
from cartslam_tpu_torch.utils.plane_params import HistogramPeakPlaneParameterProvider as TProvider

H, W, D, FRAMES, RESUME_AFTER = 64, 128, 32, 6, 3


def _source():
    return SyntheticDataSource(image_size=(H, W), num_frames=FRAMES, seed=0,
                               max_disparity=0.7 * D, baseline=20.0)


def _modules(M, provider):
    sp = M.SuperPixelModule((H, W), initial_iterations=3, iterations=2, block_size=8,
                            reset_iterations=4)
    return [
        M.ImageDisparityModule((H, W), min_disparity=4, num_disparities=D,
                               smoothing_radius=2, smoothing_iterations=1),
        M.ImageDisparityDerivativeModule(),
        M.DepthModule(),
        sp,
        M.SuperPixelDisparityPlaneSegmentationModule(provider, num_labels=sp.num_labels,
                                                     update_interval=3),
    ]


def _torch_pipeline(q):
    return Pipeline(PipelineContext(height=H, width=W, q=q, device="cpu"),
                    _modules(tm, TProvider()))


@pytest.fixture(scope="module")
def reference():
    """The JAX run: frames, per-frame outputs/state/host params, and the
    state + host state after RESUME_AFTER frames."""
    src = _source()
    pipe = JPipeline(JContext(height=H, width=W, q=src.get_camera_intrinsics().q),
                     _modules(jm, JProvider()))
    state, params = pipe.init_state(), pipe.init_host_params()
    frames, record, resume = [], [], None
    for fid in range(1, FRAMES + 1):
        f = src.get_next()
        frames.append(f)
        step = pipe.make_step(pipe.variant(fid))
        state, out = step(state, {**f, "frame_id": np.int32(fid)}, params)
        out = {k: np.asarray(v) for k, v in out.items()}
        for m in pipe.modules:
            upd = m.host_update(pipe.ctx, fid, {k: out[k] for k in m.host_fetch_keys()})
            if upd:
                params[m.name] = {**params[m.name], **upd}
        state_np = jax.tree.map(np.asarray, state)
        record.append((out, state_np, {k: dict(v) for k, v in params.items()}))
        if fid == RESUME_AFTER:
            resume = (state_np, {k: dict(v) for k, v in params.items()},
                      pipe.modules[-1].host_state())
    return frames, record, resume


def _assert_tree_equal(port, ref, where):
    if isinstance(ref, dict):
        assert set(port) == set(ref), where
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{where}/{k}")
        return
    ref = np.asarray(ref)
    port = np.asarray(port)
    assert port.dtype == ref.dtype and port.shape == ref.shape, where
    if where.endswith("/depth"):
        np.testing.assert_array_equal(np.isnan(port), np.isnan(ref), err_msg=where)
        np.testing.assert_array_equal(np.isinf(port), np.isinf(ref), err_msg=where)
        fin = np.isfinite(ref)
        a = port[fin].view(np.int32).astype(np.int64)
        b = ref[fin].view(np.int32).astype(np.int64)
        assert np.abs(a - b).max(initial=0) <= 2, where
    else:
        np.testing.assert_array_equal(port, ref, err_msg=where)


def _run_port(pipe, frames, record, first, state, params):
    for fid in range(first, FRAMES + 1):
        state, out = pipe.step(state, frame_to_device(frames[fid - 1], fid, "cpu"),
                               params, pipe.variant(fid))
        params = host_step(pipe, fid, out, params)
        ref_out, ref_state, ref_params = record[fid - 1]
        _assert_tree_equal(state_to_numpy(out), ref_out, f"frame {fid} outputs")
        _assert_tree_equal(state_to_numpy(state), ref_state, f"frame {fid} state")
        _assert_tree_equal(params, ref_params, f"frame {fid} host params")
    return out


def test_slice_matches_jax_every_frame(reference):
    frames, record, _ = reference
    q = _source().get_camera_intrinsics().q
    pipe = _torch_pipeline(q)
    kbuild.reset_counts()
    out = _run_port(pipe, frames, record, 1, pipe.init_state(), pipe.init_host_params())
    # The provider has refreshed the ranges and the planes carry all classes.
    assert np.asarray(record[-1][2]["SPPlaneSegmentation"]["ranges"]).any()
    assert len(np.unique(out["planes"].numpy())) == 3
    # On CPU tensors every kernel wrapper ran its plain version, never a
    # kernel; the slice's kernels are K1-K4 (K6 and K7 sit off its path).
    counts = {c.name: (c.launches, c.plain_calls) for c in kbuild.COUNTERS.values()}
    assert all(launches == 0 for launches, _ in counts.values()), counts
    assert all(counts[k][1] > 0 for k in ("sgm", "moment_tally", "relax", "vote_tally")), counts


def test_slice_resumes_from_jax_state(reference):
    """Start the port mid-sequence from the JAX pipeline's state."""
    frames, record, (state_np, params_np, host_state) = reference
    pipe = _torch_pipeline(_source().get_camera_intrinsics().q)
    pipe.modules[-1].restore_host_state(host_state)
    state = state_from_reference(state_np, "cpu")
    assert state["modules"]["SuperPixelDetect"]["labels"].dtype == torch.int32
    _run_port(pipe, frames, record, RESUME_AFTER + 1, state, params_np)


@pytest.mark.parametrize("seed", [0, 1, 2])  # the seeds a 3-sequence multiseq run replicates
def test_synthetic_source_copy_matches_jax_package(seed):
    ref = SyntheticDataSource(image_size=(H, W), num_frames=FRAMES, seed=seed,
                              max_disparity=0.7 * D, baseline=20.0)
    port = TSyntheticDataSource(image_size=(H, W), num_frames=FRAMES, seed=seed,
                                max_disparity=0.7 * D, baseline=20.0)
    np.testing.assert_array_equal(port.get_camera_intrinsics().q, ref.get_camera_intrinsics().q)
    for _ in range(2):
        a, b = ref.get_next(), port.get_next()
        np.testing.assert_array_equal(a["left"], b["left"])
        np.testing.assert_array_equal(a["right"], b["right"])


def test_cli_runs_synthetic_config_on_cpu():
    cfg = pathlib.Path(__file__).resolve().parent.parent / "configs" / "synthetic-planeseg.json"
    assert torch_main([str(cfg), "--device", "cpu", "--max-frames", "2"]) == 0


def test_registry_rejects_unported_types(tmp_path):
    src = {"type": "synthetic", "image_size": [16, 32], "num_frames": 1}
    # Every module type of the JAX registry is ported; an unknown one is
    # refused with the JAX message.
    with pytest.raises(ValueError, match="unknown module type 'stereo_magic'"):
        build_pipeline(src, [{"type": "stereo_magic"}], device="cpu")
    # Host modules (the visualizations, the plane fits) need a System.
    for mtype in ("features_visualization", "disparity_planeseg_visualization"):
        with pytest.raises(ValueError, match="need a System: use build_system"):
            build_pipeline(src, [{"type": mtype}], device="cpu")
    with pytest.raises(ValueError, match="unknown temporal_mode 'exact'"):
        build_pipeline(src, [{"type": "superpixels"},
                             {"type": "superpixel_disparity_planeseg",
                              "parameter_provider": {"type": "histogram_peak"},
                              "use_temporal_smoothing": True, "temporal_mode": "exact"}],
                       device="cpu")
    # The multi-sequence modes are ported: they build a MultiSeqSystem /
    # SpatialMultiSeqSystem, which only a System entry point returns;
    # "multihost" is not ported.
    cfg = tmp_path / "multiseq.json"
    cfg.write_text('{"data_source": {"type": "synthetic"}, "modules": [], '
                   '"parallel": {"mode": "multiseq", "batch": 2}}')
    system = read_system_config(str(cfg), device="cpu")
    assert isinstance(system, MultiSeqSystem) and system.batch == 2
    for seed, source in enumerate(system.sources):  # the config's seed + i
        np.testing.assert_array_equal(source.get_next()["left"],
                                      TSyntheticDataSource(seed=seed).get_next()["left"])
    composed = build_system(src, [], device="cpu",
                            parallel={"mode": "spatial", "devices": 2, "sequences": 2})
    assert isinstance(composed, SpatialMultiSeqSystem) and composed.pipeline.n == 1
    for build in (lambda: read_config(str(cfg), device="cpu"),
                  lambda: build_pipeline(src, [], device="cpu", parallel={
                      "mode": "spatial", "devices": 2, "sequences": 2})):
        with pytest.raises(ValueError, match="multi-sequence modes .* use build_system"):
            build()
    with pytest.raises(ValueError, match="'multihost' is not ported yet"):
        build_system(src, [], device="cpu",
                     parallel={"mode": "multiseq", "batch": 2, "multihost": {}})


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline({"type": "synthetic", "image_size": [16, 32]}, [], device="cuda")


def test_entry_points_default_to_the_card():
    """build_pipeline, read_config and PipelineContext target CUDA unless the
    caller asks for the CPU; with no GPU that raises, with no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline({"type": "synthetic", "image_size": [16, 32]}, [])
    cfg = pathlib.Path(__file__).resolve().parent.parent / "configs" / "synthetic-planeseg.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_config(str(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineContext(height=8, width=8, q=np.eye(4, dtype=np.float32))


def test_pipeline_errors_match_jax_messages():
    ctx = PipelineContext(height=8, width=8, q=np.eye(4, dtype=np.float32), device="cpu")
    with pytest.raises(PipelineError, match="requires 'disparity' which no module provides"):
        Pipeline(ctx, [tm.ImageDisparityDerivativeModule()])
    with pytest.raises(PipelineError, match="provided by both"):
        Pipeline(ctx, [tm.DepthModule(), tm.DepthModule(),
                       tm.ImageDisparityModule((8, 8), num_disparities=4)])
