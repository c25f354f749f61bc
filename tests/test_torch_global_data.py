"""The global data the plane segmentations publish through the System,
against the JAX package, on the CPU.

Under a System the pixel and the superpixel plane segmentation publish
``disp_derivative_histogram_live`` every frame, and ``plane_parameters`` and
``disp_derivative_histogram`` at each provider update;
``PlaneSegmentationVisualization`` draws its "Plane Segmentation Histogram"
window from them.  Held here, on a seeded synthetic source at 32x64 with 48
disparities, a histogram-peak provider updating every 2 frames and resetting
every 4 (so both land inside the 6 frames):

  * the JAX System and the port's System, for both plane segmentations, at
    1 and 4 frames in flight: each frame, the global data's keys equal, the
    histograms array_equal, the PlaneParameters' fields equal, read
    after the frame's host step (a published array that a later ``+=`` or
    reset changed would show at the next frame), and every window the visualization
    renders through the image sink, the histogram window included,
    array_equal to JAX's;
  * the same global data for MultiSeqSystem at B=2, whose provider sees the
    summed histogram, and the histogram window drawn from it.

The JAX steps run unjitted, with the eager relax of
tests/test_torch_faithful.py (jitted XLA:CPU contracts FMAs).
"""

import dataclasses

import jax
import numpy as np
import pytest
from test_torch_faithful import _one_intra_op_thread, eager_jax_relax  # noqa: F401 (fixtures)

from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.parallel.system import MultiSeqSystem as JMultiSeqSystem
from cartslam_tpu.sources.synthetic import SyntheticDataSource as JSource
from cartslam_tpu.viz import host_modules as jvm
from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.sources import SyntheticDataSource as TSource
from cartslam_tpu_torch.viz import host_modules as tvm

H, W, D, FRAMES, B = 32, 64, 48, 6, 2
PROVIDER = {"parameter_provider": {"type": "histogram_peak"}, "update_interval": 2,
            "reset_interval": 2}
DISPARITY = {"type": "disparity", "num_disparities": D, "min_disparity": 0,
             "smoothing_radius": 2, "smoothing_iterations": 1}
VIS = {"type": "disparity_planeseg_visualization", "show_histogram": True}
MODULES = {
    "pixel": [DISPARITY, {"type": "disparity_planeseg", **PROVIDER}, VIS],
    "superpixel": [
        {"type": "superpixels", "initial_iterations": 3, "iterations": 2, "block_size": 8,
         "reset_iterations": 4},
        DISPARITY, {"type": "disparity_derivative"},
        {"type": "superpixel_disparity_planeseg", **PROVIDER}, VIS,
    ],
}
GLOBAL_KEYS = {"disp_derivative_histogram_live", "plane_parameters",
               "disp_derivative_histogram"}
HIST_WINDOW = "Plane Segmentation Histogram"


class _Recorder:
    """An image sink that keeps every window a frame renders; `run` also
    keeps the System's global data as it stood after each frame's host
    step (arrays copied, so a later change to a published array shows)."""

    def __init__(self):
        self.images, self.globals = {}, {}

    def set_image_if_later(self, window, image, frame_id):
        self.images.setdefault(frame_id, {})[window] = np.array(image)

    def run(self, system):
        def on_frame(fid, _):
            self.globals[fid] = {k: v if dataclasses.is_dataclass(v) else np.array(v)
                                 for k, v in system.global_data.items()}
        n = system.run(on_frame=on_frame)
        assert n and not system.failed_frames
        return self


def _sources(cls, n):
    return [cls(image_size=(H, W), num_frames=FRAMES, seed=i, max_disparity=0.4 * D,
                baseline=20.0) for i in range(n)]


def _jax_system(path, max_in_flight, batch):
    sink = _Recorder()
    if batch is None:
        system = jax_build_system(_sources(JSource, 1)[0], MODULES[path], image_sink=sink,
                                  max_in_flight=max_in_flight)
        pipe = system.pipeline
        pipe.jitted_step = lambda variant, keys: pipe.make_step(variant, keys)
        return sink.run(system)
    single = jax_build_system(_sources(JSource, 1)[0], MODULES[path])
    system = JMultiSeqSystem(_sources(JSource, batch), single.pipeline, single.host_modules,
                             devices=jax.devices()[:1], image_sink=sink,
                             max_in_flight=max_in_flight)
    pipe = system.pipeline
    system._jitted = lambda variant, keys: jax.vmap(pipe.make_step(variant, keys),
                                                    in_axes=(0, 0, None))
    return sink.run(system)


def _port_system(path, max_in_flight, batch):
    sink = _Recorder()
    sources = _sources(TSource, batch or 1)
    parallel = None if batch is None else {"mode": "multiseq", "batch": batch,
                                           "sources": sources}
    system = build_system(sources[0], MODULES[path], device="cpu", image_sink=sink,
                          max_in_flight=max_in_flight, parallel=parallel)
    return sink.run(system)


def _histogram_windows(vm, globals_):
    """The windows `vm`'s PlaneSegmentationVisualization renders from
    `globals_` over a blank frame."""
    frame = {"left": np.zeros((H, W, 3), np.uint8)}
    fetched = {"planes": np.zeros((H, W), np.uint8)}
    return vm.PlaneSegmentationVisualization(show_histogram=True).render(
        None, 1, frame, fetched, globals_)


@pytest.mark.parametrize("path,max_in_flight,batch", [
    ("pixel", 1, None), ("pixel", 4, None), ("superpixel", 1, None), ("superpixel", 4, None),
    ("pixel", 4, B),
], ids=["pixel-1", "pixel-4", "superpixel-1", "superpixel-4", f"pixel-multiseq-B{B}"])
def test_global_data_and_histogram_window_match_jax(path, max_in_flight, batch):
    want = _jax_system(path, max_in_flight, batch)
    got = _port_system(path, max_in_flight, batch)
    assert sorted(got.globals) == sorted(want.globals) == list(range(1, FRAMES + 1))
    for fid in want.globals:
        g, w = got.globals[fid], want.globals[fid]
        # The provider updates on frame 1, so all three keys are there from
        # frame 1 on.
        assert set(g) == set(w) == GLOBAL_KEYS, f"frame {fid}: {sorted(g)} != {sorted(w)}"
        assert dataclasses.asdict(g["plane_parameters"]) == \
            dataclasses.asdict(w["plane_parameters"]), f"frame {fid}"
        for k in GLOBAL_KEYS - {"plane_parameters"}:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"frame {fid} {k}")
        if batch is None:
            images = got.images[fid], want.images[fid]
        else:
            # The multi-sequence host modules render sequence 0 with no
            # frame, where this visualization draws nothing in either
            # package: its windows are drawn from each frame's global data.
            assert not got.images and not want.images
            images = _histogram_windows(tvm, g), _histogram_windows(jvm, w)
        assert set(images[0]) == set(images[1]) and HIST_WINDOW in images[1], f"frame {fid}"
        for win, img in images[1].items():
            np.testing.assert_array_equal(images[0][win], img, err_msg=f"frame {fid} {win}")
