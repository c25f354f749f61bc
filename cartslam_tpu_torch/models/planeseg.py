"""DisparityPlaneSegmentationModule, the pixel-level plane segmentation
(counterpart of cartslam_tpu/models/planeseg.py).

Device step: the module's own low-pass vertical derivative and its 256-bin
histogram (``ops/derivative.planeseg_derivative``), range classification,
and optionally the temporal majority vote with current-frame weight 1 over
the previous ``temporal_smoothing_distance`` frames: the carried
flow-warped accumulator (``temporal_mode="carried"``) or the reference's K
gathers from the flow history (``"faithful"``).

Host step: every frame's histogram adds to a running total; at frame ids
== 1 (mod update_interval) the provider re-derives the class ranges from
it, and the total resets at frame ids == 1 (mod update_interval *
reset_interval).  The new ranges apply from the first frame dispatched
after the host step ran: with the System's default 4 frames in flight,
frame t's update applies from frame t + 4 (runtime/system.py).  Under a
System the host step publishes into its global data, as the JAX module
does: the running total every frame (``disp_derivative_histogram_live``),
and the provider's parameters and the interval snapshot at each update;
the plane segmentation visualization draws its histogram window from them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import derivative as dops
from ..ops import planeseg as pops
from ..runtime.module import Dependency, Module, PipelineContext, TensorSpec
from ..utils.plane_params import PlaneParameterProvider, PlaneParameters

KEY_DISPARITY = "disparity"
KEY_OPTFLOW = "optflow"
KEY_PLANES = "planes"
KEY_PLANES_UNSMOOTHED = "planes_unsmoothed"
KEY_FRAME_HIST = "planeseg_frame_histogram"
KEY_PLANE_PARAMETERS = "plane_parameters"
KEY_GLOBAL_HIST = "disp_derivative_histogram"


class DisparityPlaneSegmentationModule(Module):
    name = "PlaneSegmentation"

    def __init__(self, provider: PlaneParameterProvider, update_interval: int = 30,
                 reset_interval: int = 10, use_temporal_smoothing: bool = False,
                 temporal_smoothing_distance: int = 3, temporal_mode: str = "carried",
                 warp_mode: str = "auto", max_warp_y: int = 32, max_warp_x: int = 64):
        if temporal_mode not in pops.TEMPORAL_MODES:
            raise ValueError(f"unknown temporal_mode {temporal_mode!r}; expected one of "
                             f"{pops.TEMPORAL_MODES}")
        if warp_mode not in pops.WARP_MODES:
            raise ValueError(f"unknown warp_mode {warp_mode!r}; expected one of {pops.WARP_MODES}")
        self.provider = provider
        self.update_interval = update_interval
        self.reset_interval = reset_interval
        self.temporal = use_temporal_smoothing
        self.distance = temporal_smoothing_distance
        self.temporal_mode = temporal_mode
        self.warp_mode = warp_mode
        self.max_warp_y = max_warp_y
        self.max_warp_x = max_warp_x
        self._running = np.zeros(256, np.int64)

    def provides(self):
        keys = [KEY_PLANES, KEY_FRAME_HIST]
        if self.temporal:
            keys.append(KEY_PLANES_UNSMOOTHED)
        return keys

    def requires(self):
        deps = [Dependency(KEY_DISPARITY)]
        if self.temporal:
            deps += pops.temporal_dependencies(self.temporal_mode, self.distance, KEY_OPTFLOW,
                                               KEY_PLANES_UNSMOOTHED)
        return deps

    def init_state(self, ctx: PipelineContext):
        if not self.temporal or self.temporal_mode == "faithful":
            return {}
        return {"warp_votes": torch.full((self.distance, ctx.height, ctx.width),
                                         pops.WARP_INVALID, dtype=torch.uint8,
                                         device=ctx.device)}

    def output_spec(self, ctx: PipelineContext):
        planes = TensorSpec((ctx.height, ctx.width), torch.uint8)
        spec = {KEY_PLANES: planes, KEY_FRAME_HIST: TensorSpec((256,), torch.int32)}
        if self.temporal:
            spec[KEY_PLANES_UNSMOOTHED] = planes
        return spec

    def initial_host_params(self, ctx: PipelineContext):
        return {"ranges": self.provider.get().ranges_array()}

    def host_fetch_keys(self):
        return [KEY_FRAME_HIST]

    def host_fetch_reduce(self):
        return {KEY_FRAME_HIST: "sum"}  # an additive histogram

    def host_state(self):
        p = self.provider.get()
        return {
            "running_hist": self._running.copy(),
            "h_range": np.array(p.horizontal_range),
            "v_range": np.array(p.vertical_range),
        }

    def restore_host_state(self, state):
        self._running = np.asarray(state["running_hist"]).astype(np.int64)
        h = tuple(int(v) for v in state["h_range"])
        v = tuple(int(v) for v in state["v_range"])
        self.provider.params = PlaneParameters(
            horizontal_range=h,
            vertical_range=v,
            horizontal_center=(h[0] + h[1]) // 2,
            vertical_center=(v[0] + v[1]) // 2,
        )

    def host_update(self, ctx, frame_id, fetched, system=None):
        self._running += fetched[KEY_FRAME_HIST].astype(np.int64)
        if system is not None:
            # A copy: the running total keeps growing and resets in place.
            system.insert_global_data(KEY_GLOBAL_HIST + "_live", self._running.copy())
        if frame_id % self.update_interval != 1:
            return None
        snapshot = self._running.copy()
        if frame_id % (self.update_interval * self.reset_interval) == 1:
            self._running[:] = 0
        self.provider.update(snapshot)
        params = self.provider.get()
        if system is not None:
            system.insert_global_data(KEY_PLANE_PARAMETERS, params)
            system.insert_global_data(KEY_GLOBAL_HIST, snapshot)
        return {"ranges": params.ranges_array()}

    def compute(self, ctx, step, deps, state, params, variant):
        deriv, hist = dops.planeseg_derivative(deps[KEY_DISPARITY])
        planes = pops.classify(deriv, params["ranges"])
        outputs = {KEY_FRAME_HIST: hist}
        if not self.temporal:
            outputs[KEY_PLANES] = planes
            return outputs, {}
        outputs[KEY_PLANES_UNSMOOTHED] = planes
        if self.temporal_mode == "faithful":
            outputs[KEY_PLANES] = pops.temporal_vote_from_history(
                planes, step, deps[KEY_OPTFLOW], self.distance, KEY_OPTFLOW,
                KEY_PLANES_UNSMOOTHED, current_weight=1, compare_unknown=False)
            return outputs, {}
        prev = torch.where(step.frame_id > 1, step.history(KEY_PLANES_UNSMOOTHED, -1),
                           pops.WARP_INVALID)
        outputs[KEY_PLANES], warp_votes = pops.temporal_vote_warped(
            planes, prev, state["warp_votes"], deps[KEY_OPTFLOW],
            current_weight=1, compare_unknown=False, warp_mode=self.warp_mode,
            max_warp_y=self.max_warp_y, max_warp_x=self.max_warp_x,
        )
        return outputs, {"warp_votes": warp_votes}

    # ------------------------------------------------------ spatial (sharded)

    def spatial_row_dims(self, ctx):
        # The histogram is a global reduction (psum'd); warp_votes stacks the
        # temporal distance ahead of the row axis.
        return {KEY_FRAME_HIST: None, "warp_votes": 1}

    def spatial_validate(self, ctx, n, h_local):
        if self.temporal and self.temporal_mode == "faithful":
            raise ValueError("spatial mode supports temporal_mode='carried' only")

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        """Sharded pixel plane segmentation, equal to the full frame: the
        derivative reaches 3 rows (the 5-tap mean, then the +-1 difference),
        so it runs on 3-row edge halos; beyond the frame's top and bottom
        the smoothed rows are the frame's edge row, as the full frame's
        clamped difference reads them.  (The JAX package's spatial mode
        smooths the duplicated rows instead and differs from its full frame
        on rows 0 and H-1.)  The histogram re-tallies the core rows' raw
        values and psums.  The temporal vote takes `max_warp_y`-row halos
        and the 'select' warp, as models/sp_planeseg.py does."""
        halo, hl = 3, sp.h_local
        smoothed = dops.planeseg_smooth(sp.exchange(deps[KEY_DISPARITY], halo, halo))
        rows = torch.arange(sp.row0 - halo, sp.row0 + hl + halo, device=ctx.device)
        smoothed = smoothed[rows.clamp(0, ctx.height - 1) - (sp.row0 - halo)]
        raw, ok = dops.planeseg_diff(smoothed)
        raw, ok = raw[halo : halo + hl], ok[halo : halo + hl]
        hist = sp.psum(dops.hist256(raw, ok))
        planes = pops.classify(torch.where(ok, raw, dops.DERIVATIVE_INVALID).to(torch.int16),
                               params["ranges"])
        outputs = {KEY_FRAME_HIST: hist}
        if not self.temporal:
            outputs[KEY_PLANES] = planes
            return outputs, {}
        ry = min(self.max_warp_y, sp.h_local)
        prev = torch.where(step.frame_id > 1, step.history(KEY_PLANES_UNSMOOTHED, -1),
                           pops.WARP_INVALID)
        inv = pops.WARP_INVALID
        votes_ext = sp.exchange(state["warp_votes"].transpose(0, 1), ry, ry, fill=inv)
        smoothed_ext, warp_ext = pops.temporal_vote_warped(
            sp.exchange(planes, ry, ry, fill=pops.UNKNOWN),
            sp.exchange(prev, ry, ry, fill=inv),
            votes_ext.transpose(0, 1),
            sp.exchange(deps[KEY_OPTFLOW], ry, ry, fill=0),
            current_weight=1, compare_unknown=False, warp_mode="select",
            max_warp_y=ry, max_warp_x=self.max_warp_x,
        )
        outputs[KEY_PLANES] = smoothed_ext[ry : ry + sp.h_local]
        outputs[KEY_PLANES_UNSMOOTHED] = planes
        return outputs, {"warp_votes": warp_ext[:, ry : ry + sp.h_local].contiguous()}
