"""The port's pixel plane segmentation and grayscale switch against the
JAX package, on the CPU.

  * configs/kitti-naive-segmentation-temporal.json's device modules
    (optical flow, disparity, the pixel plane segmentation) over 6 frames
    in both temporal modes, every output, the state and the host params,
    and resumed from the JAX state; both naive-segmentation configs build;
  * the pixel module's carried spatial mode against the port's full frame;
  * the grayscale switch (frames converted at the source boundary), full
    frame and spatial, against the JAX system (build_system(...,
    grayscale=True)).

Every comparison is array_equal (depth within 2 ulp).  The JAX relax runs
eagerly, as in tests/test_torch_faithful.py, whose helpers this file shares.
"""

import json

import numpy as np
import pytest
import torch
from test_torch_faithful import (  # noqa: F401 (fixtures)
    D,
    FRAMES,
    H,
    REPO,
    RESUME_AFTER,
    W,
    _assert_tree_equal,
    _jax_run,
    _one_intra_op_thread,
    _run_port,
    eager_jax_relax,
)

from cartslam_tpu import models as jm
from cartslam_tpu.config import build_system
from cartslam_tpu.utils.plane_params import HistogramPeakPlaneParameterProvider as JProvider
from cartslam_tpu_torch import models as tm
from cartslam_tpu_torch.config import build_pipeline
from cartslam_tpu_torch.kernels import build as kbuild
from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
from cartslam_tpu_torch.runtime import run, state_to_numpy
from cartslam_tpu_torch.utils.plane_params import HistogramPeakPlaneParameterProvider as TProvider


def _pixel(M, provider, temporal_mode):
    """configs/kitti-naive-segmentation-temporal.json's device modules at the
    small geometry (the visualization is a host module, not ported)."""
    return [
        M.ImageOpticalFlowModule((H, W)),
        M.ImageDisparityModule((H, W), min_disparity=4, num_disparities=D,
                               smoothing_radius=2, smoothing_iterations=1),
        M.DisparityPlaneSegmentationModule(provider, update_interval=3,
                                           use_temporal_smoothing=True,
                                           temporal_mode=temporal_mode),
    ]


@pytest.mark.parametrize("temporal_mode", ["carried", "faithful"])
def test_pixel_planeseg_matches_jax(temporal_mode):
    frames, record, resume = _jax_run(_pixel(jm, JProvider(), temporal_mode))
    state, out = _run_port(_pixel(tm, TProvider(), temporal_mode), frames, record)
    assert out["planeseg_frame_histogram"].sum() > 0 and len(np.unique(out["planes"])) == 3
    assert (out["planes"] != out["planes_unsmoothed"]).any()
    _run_port(_pixel(tm, TProvider(), temporal_mode), frames, record, RESUME_AFTER + 1, resume)


def test_naive_segmentation_configs_build():
    src = {"type": "synthetic", "image_size": [48, 96], "num_frames": 1}
    for name, temporal in (("kitti-naive-segmentation.json", False),
                           ("kitti-naive-segmentation-temporal.json", True)):
        mods = json.loads((REPO / "configs" / name).read_text())["modules"]
        mods = [m for m in mods if not m["type"].endswith("_visualization")]
        pipe, _ = build_pipeline(src, mods, device="cpu")
        seg = pipe.modules[-1]
        assert isinstance(seg, tm.DisparityPlaneSegmentationModule)
        assert seg.temporal == temporal and seg.temporal_mode == "carried"
        assert seg.update_interval == 30 and seg.distance == 3 and seg.max_warp_y == 32


def test_pixel_planeseg_spatial_matches_full_frame():
    """The carried temporal mode on 4 shards of 16 rows through the loop
    equals the port's full frame with the 'select' warp (histogram-peak
    updates at frames 1 and 3, the psum'd histogram); the faithful mode is
    refused in the spatial mode, as in the JAX package."""
    mods = [{"type": "optflow", "levels": 3, "search": 2, "refine": 1},
            {"type": "disparity", "num_disparities": D, "min_disparity": 4,
             "smoothing_radius": 2, "smoothing_iterations": 1},
            {"type": "disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
             "update_interval": 2, "use_temporal_smoothing": True, "max_warp_y": 8}]
    src = {"type": "synthetic", "image_size": [H, W], "num_frames": 4}
    runs = []
    for parallel, warp in (({"mode": "spatial", "devices": 4}, "auto"), (None, "select")):
        pipe, source = build_pipeline(src, mods[:2] + [dict(mods[2], warp_mode=warp)],
                                      device="cpu", parallel=parallel)
        seen = []
        res = run(pipe, source, on_frame=lambda fid, out: seen.append(state_to_numpy(out)))
        runs.append((seen, res.host_params))
    (got, got_params), (want, want_params) = runs
    for fid, (a, b) in enumerate(zip(got, want), start=1):
        _assert_tree_equal(a, b, f"frame {fid}")
    _assert_tree_equal(got_params, want_params, "host params")
    assert (got[-1]["planes"] != got[-1]["planes_unsmoothed"]).any()
    with pytest.raises(ValueError, match="temporal_mode='carried' only"):
        build_pipeline(src, mods[:2] + [dict(mods[2], temporal_mode="faithful")],
                       device="cpu", parallel={"mode": "spatial", "devices": 4})
    with pytest.raises(ValueError, match="temporal_mode='carried' only"):
        build_pipeline(src, [{"type": "superpixels", "initial_iterations": 4, "iterations": 2},
                             {"type": "optflow"},
                             {"type": "disparity_derivative"},
                             {"type": "disparity", "num_disparities": 8},
                             {"type": "superpixel_disparity_planeseg",
                              "parameter_provider": {"type": "histogram_peak"},
                              "use_temporal_smoothing": True, "temporal_mode": "faithful"}],
                       device="cpu", parallel={"mode": "spatial", "devices": 4})


# ------------------------------------------------------------- grayscale

GRAY_MODULES = [
    {"type": "disparity", "num_disparities": D, "min_disparity": 1},
    {"type": "disparity_derivative"},
    {"type": "depth"},
    {"type": "optflow", "levels": 3, "search": 2, "refine": 1},
    {"type": "superpixels", "block_size": 8, "initial_iterations": 4, "iterations": 2},
    {"type": "superpixel_disparity_planeseg",
     "parameter_provider": {"type": "static", "horizontal_range_min": 3,
                            "horizontal_range_max": 40, "vertical_range_min": -6,
                            "vertical_range_max": 3},
     "use_temporal_smoothing": True, "warp_mode": "select", "max_warp_y": 8},
]
GRAY_SRC = {"type": "synthetic", "image_size": [H, W], "num_frames": 4}
GRAY_KEYS = ["disparity", "disparity_derivative", "disparity_derivative_histogram", "depth",
             "optflow", "superpixels", "superpixels_max_label", "planes", "planes_unsmoothed"]


@pytest.fixture(scope="module")
def gray_reference():
    """JAX build_system(..., grayscale=True): the frames converted at the
    source boundary, every output of every frame.  Its step runs unjitted
    (with the eager relax), as the other JAX references here do."""
    system = build_system(dict(GRAY_SRC), GRAY_MODULES, grayscale=True, max_in_flight=1,
                          extra_fetch_keys=GRAY_KEYS)
    pipe = system.pipeline
    pipe.jitted_step = lambda variant, fetch_keys: pipe.make_step(variant, fetch_keys)
    seen = {}
    assert system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)})) == 4
    assert not system.failed_frames
    return [{k: np.asarray(seen[fid][k]) for k in GRAY_KEYS} for fid in range(1, 5)]


@pytest.mark.parametrize("parallel", [None, {"mode": "spatial", "devices": 4}],
                         ids=["full_frame", "spatial"])
def test_grayscale_matches_jax_system(gray_reference, parallel):
    pipe, source = build_pipeline(dict(GRAY_SRC), GRAY_MODULES, device="cpu", grayscale=True,
                                  parallel=parallel)
    assert isinstance(pipe, SpatialPipeline) == (parallel is not None)
    kbuild.reset_counts()
    seen = []
    res = run(pipe, source, on_frame=lambda fid, out: seen.append(state_to_numpy(out)))
    assert res.frames == 4
    for fid, (got, want) in enumerate(zip(seen, gray_reference), start=1):
        _assert_tree_equal({k: got[k] for k in GRAY_KEYS}, want, f"frame {fid}")
    assert seen[-1]["superpixels"].shape == (H, W) and (seen[-1]["optflow"] != 0).any()
