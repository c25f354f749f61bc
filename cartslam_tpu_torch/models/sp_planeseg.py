"""SuperPixelDisparityPlaneSegmentationModule, non-temporal branch
(counterpart of cartslam_tpu/models/sp_planeseg.py).

Pixel classification of the vertical derivative (channel 0), then the
per-superpixel majority vote (kernel K4 on the device).  The host step keeps
the running histogram of channel 0 of the derivative histogram: the first
contribution is skipped, the total resets at frame ids == 1 (mod
update_interval * reset_interval), and the provider refreshes the class
ranges at frame ids == 1 (mod update_interval).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import planeseg as pops
from ..runtime.module import Dependency, Module, PipelineContext, TensorSpec
from ..utils.plane_params import PlaneParameterProvider, PlaneParameters

KEY_SUPERPIXELS = "superpixels"
KEY_MAX_LABEL = "superpixels_max_label"
KEY_DERIVATIVE = "disparity_derivative"
KEY_DERIVATIVE_HISTOGRAM = "disparity_derivative_histogram"
KEY_PLANES = "planes"


class SuperPixelDisparityPlaneSegmentationModule(Module):
    name = "SPPlaneSegmentation"

    def __init__(self, provider: PlaneParameterProvider, num_labels: int,
                 update_interval: int = 30, reset_interval: int = 10,
                 use_temporal_smoothing: bool = False):
        if use_temporal_smoothing:
            raise ValueError(
                "superpixel_disparity_planeseg with use_temporal_smoothing is "
                "not ported yet"
            )
        self.provider = provider
        self.num_labels = num_labels
        self.update_interval = update_interval
        self.reset_interval = reset_interval
        self._running: np.ndarray | None = None

    def provides(self):
        return [KEY_PLANES]

    def requires(self):
        return [
            Dependency(KEY_SUPERPIXELS),
            Dependency(KEY_MAX_LABEL),
            Dependency(KEY_DERIVATIVE),
            Dependency(KEY_DERIVATIVE_HISTOGRAM),
        ]

    def output_spec(self, ctx: PipelineContext):
        return {KEY_PLANES: TensorSpec((ctx.height, ctx.width), torch.uint8)}

    def initial_host_params(self, ctx: PipelineContext):
        return {"ranges": self.provider.get().ranges_array()}

    def host_fetch_keys(self):
        return [KEY_DERIVATIVE_HISTOGRAM]

    def host_state(self):
        p = self.provider.get()
        return {
            "running_hist": (
                self._running.copy() if self._running is not None else np.zeros(0)
            ),
            "h_range": np.array(p.horizontal_range),
            "v_range": np.array(p.vertical_range),
        }

    def restore_host_state(self, state):
        rh = np.asarray(state["running_hist"])
        self._running = rh.astype(np.int64) if rh.size else None
        h = tuple(int(v) for v in state["h_range"])
        v = tuple(int(v) for v in state["v_range"])
        self.provider.params = PlaneParameters(
            horizontal_range=h,
            vertical_range=v,
            horizontal_center=(h[0] + h[1]) // 2,
            vertical_center=(v[0] + v[1]) // 2,
        )

    def host_update(self, ctx, frame_id, fetched):
        hist = fetched[KEY_DERIVATIVE_HISTOGRAM][:, 0].astype(np.int64)  # vertical
        if self._running is None:
            # The reference drops the first contribution.
            self._running = np.zeros_like(hist)
            snapshot = hist
        else:
            self._running += hist
            snapshot = self._running.copy()
        if frame_id % (self.update_interval * self.reset_interval) == 1:
            self._running[:] = 0
        if frame_id % self.update_interval != 1:
            return None
        self.provider.update(snapshot)
        return {"ranges": self.provider.get().ranges_array()}

    def compute(self, ctx, step, deps, state, params, variant):
        ranges = torch.as_tensor(params["ranges"], dtype=torch.int32, device=ctx.device)
        pixel_planes = pops.classify(deps[KEY_DERIVATIVE][..., 0], ranges)
        planes = pops.superpixel_vote(pixel_planes, deps[KEY_SUPERPIXELS], self.num_labels)
        return {KEY_PLANES: planes}, {}
