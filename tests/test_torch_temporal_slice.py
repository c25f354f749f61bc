"""The port's temporal flagship against the JAX pipeline, on the CPU.

Both packages run the flagship's six device modules in the order of
configs/kitti-planeseg.json (superpixels, optical flow, disparity,
derivative, depth, superpixel plane segmentation with the carried
flow-warped temporal vote) on the same synthetic frames, with the host step
on both sides.  Every output (flow and unsmoothed planes included), all
state (``prev_gray``, ``warp_votes``, the history ring) and the host params
must be equal each frame (depth within 2 ulp).  The geometry is the
non-temporal slice test's: 64x128, 32 disparities, block 8, 3/2 sweeps, a
reset every 4 frames, a provider update every 3, 6 frames.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch
from test_torch_slice import _assert_tree_equal

from cartslam_tpu import models as jm
from cartslam_tpu.runtime.module import PipelineContext as JContext
from cartslam_tpu.runtime.pipeline import Pipeline as JPipeline
from cartslam_tpu.sources.synthetic import SyntheticDataSource
from cartslam_tpu.utils.plane_params import HistogramPeakPlaneParameterProvider as JProvider
from cartslam_tpu_torch import models as tm
from cartslam_tpu_torch.config import build_pipeline
from cartslam_tpu_torch.runtime import (
    Pipeline,
    PipelineContext,
    host_step,
    state_from_reference,
    state_to_numpy,
)
from cartslam_tpu_torch.runtime.loop import frame_to_device
from cartslam_tpu_torch.utils.plane_params import HistogramPeakPlaneParameterProvider as TProvider

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W, D, FRAMES, RESUME_AFTER = 64, 128, 32, 6, 3


def _source():
    return SyntheticDataSource(image_size=(H, W), num_frames=FRAMES, seed=0,
                               max_disparity=0.7 * D, baseline=20.0)


def _modules(M, provider):
    sp = M.SuperPixelModule((H, W), initial_iterations=3, iterations=2, block_size=8,
                            reset_iterations=4)
    return [
        sp,
        M.ImageOpticalFlowModule((H, W)),
        M.ImageDisparityModule((H, W), min_disparity=4, num_disparities=D,
                               smoothing_radius=2, smoothing_iterations=1),
        M.ImageDisparityDerivativeModule(),
        M.DepthModule(),
        M.SuperPixelDisparityPlaneSegmentationModule(provider, num_labels=sp.num_labels,
                                                     update_interval=3,
                                                     use_temporal_smoothing=True),
    ]


def _torch_pipeline():
    q = _source().get_camera_intrinsics().q
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
            keys = m.host_fetch_keys()
            if keys:
                upd = m.host_update(pipe.ctx, fid, {k: out[k] for k in keys})
                if upd:
                    params[m.name] = {**params[m.name], **upd}
        state_np = jax.tree.map(np.asarray, state)
        record.append((out, state_np, {k: dict(v) for k, v in params.items()}))
        if fid == RESUME_AFTER:
            resume = (state_np, {k: dict(v) for k, v in params.items()},
                      pipe.modules[-1].host_state())
    return frames, record, resume


def _run_port(pipe, frames, record, first, state, params):
    for fid in range(first, FRAMES + 1):
        state, out = pipe.step(state, frame_to_device(frames[fid - 1], fid, "cpu"),
                               params, pipe.variant(fid))
        params = host_step(pipe, fid, out, params)
        ref_out, ref_state, ref_params = record[fid - 1]
        _assert_tree_equal(state_to_numpy(out), ref_out, f"frame {fid} outputs")
        _assert_tree_equal(state_to_numpy(state), ref_state, f"frame {fid} state")
        _assert_tree_equal(params, ref_params, f"frame {fid} host params")
    return state, out


def test_temporal_flagship_matches_jax_every_frame(reference):
    frames, record, _ = reference
    pipe = _torch_pipeline()
    jorder = JPipeline(JContext(height=H, width=W, q=np.eye(4, dtype=np.float32)),
                       _modules(jm, JProvider())).modules
    assert [m.name for m in pipe.modules] == [m.name for m in jorder]
    state, out = _run_port(pipe, frames, record, 1, pipe.init_state(), pipe.init_host_params())
    # The camera pans: the flow is not zero, and the vote stack holds votes.
    assert (out["optflow"][..., 0] != 0).float().mean() > 0.5
    votes = state["modules"]["SPPlaneSegmentation"]["warp_votes"]
    assert (votes != 3).all(dim=0).float().mean() > 0.5
    # The temporal vote changed some pixels against the raw classification.
    assert (out["planes"] != out["planes_unsmoothed"]).any()


def test_temporal_flagship_resumes_from_jax_state(reference):
    """Start the port after frame 3 from the JAX pipeline's state, the
    flow's prev_gray and the carried vote stack included."""
    frames, record, (state_np, params_np, host_state) = reference
    pipe = _torch_pipeline()
    pipe.modules[-1].restore_host_state(host_state)
    state = state_from_reference(state_np, "cpu")
    assert state["modules"]["ImageOpticalFlow"]["prev_gray"].dtype == torch.uint8
    assert state["modules"]["SPPlaneSegmentation"]["warp_votes"].shape == (3, H, W)
    _run_port(pipe, frames, record, RESUME_AFTER + 1, state, params_np)


def test_flagship_config_builds_on_cpu():
    """configs/kitti-planeseg.json's modules, minus the host visualizations,
    as written (optflow, use_temporal_smoothing: true)."""
    import json

    mods = json.loads((REPO / "configs" / "kitti-planeseg.json").read_text())["modules"]
    mods = [m for m in mods if not m["type"].endswith("_visualization")]
    pipe, _ = build_pipeline({"type": "synthetic", "image_size": [48, 96], "num_frames": 1},
                             mods, device="cpu")
    seg = pipe.modules[-1]
    assert seg.temporal and seg.warp_mode == "auto" and seg.distance == 3
    assert "planes_unsmoothed" in pipe.history_depth
    assert any(isinstance(m, tm.ImageOpticalFlowModule) for m in pipe.modules)


@pytest.mark.parametrize("warp_mode,warns", [("select", True), ("auto", False), ("gather", False)])
def test_registry_warns_when_select_warp_can_drop_votes(caplog, warp_mode, warns):
    """The flow's static bound (42 px for the defaults) exceeds
    max_warp_y=32: only the 'select' warp drops such votes ('auto' is the
    gather in the port)."""
    mods = [{"type": "disparity", "num_disparities": 8}, {"type": "disparity_derivative"},
            {"type": "superpixels"}, {"type": "optflow"},
            {"type": "superpixel_disparity_planeseg",
             "parameter_provider": {"type": "histogram_peak"},
             "use_temporal_smoothing": True, "warp_mode": warp_mode}]
    with caplog.at_level("WARNING", logger="cart.config"):
        build_pipeline({"type": "synthetic", "image_size": [16, 32], "num_frames": 1}, mods,
                       device="cpu")
    assert ("static vertical bound is 42 px" in caplog.text) == warns
