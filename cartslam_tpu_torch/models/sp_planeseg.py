"""SuperPixelDisparityPlaneSegmentationModule (counterpart of
cartslam_tpu/models/sp_planeseg.py).

Pixel classification of the vertical derivative (channel 0), the optional
temporal vote with current-frame weight 2, then the per-superpixel majority
vote (kernel K4 on the device).  The temporal vote is the carried
flow-warped accumulator of ``ops/planeseg.temporal_vote_warped``
(``temporal_mode="carried"``), or the reference's K gathers of the previous
frames' planes from the flow history (``"faithful"``,
``ops/planeseg.temporal_vote``).  The host step keeps
the running histogram of channel 0 of the derivative histogram: the first
contribution is skipped, the total resets at frame ids == 1 (mod
update_interval * reset_interval), and the provider refreshes the class
ranges at frame ids == 1 (mod update_interval).  Under a System the host
step publishes into its global data, as the JAX module does: the running
histogram every frame (``disp_derivative_histogram_live``), and the
provider's parameters and the snapshot it was given at each update.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops import planeseg as pops
from ..runtime.module import Dependency, Module, PipelineContext, TensorSpec
from ..utils.plane_params import PlaneParameterProvider, PlaneParameters

KEY_SUPERPIXELS = "superpixels"
KEY_MAX_LABEL = "superpixels_max_label"
KEY_DERIVATIVE = "disparity_derivative"
KEY_DERIVATIVE_HISTOGRAM = "disparity_derivative_histogram"
KEY_OPTFLOW = "optflow"
KEY_PLANES = "planes"
KEY_PLANES_UNSMOOTHED = "planes_unsmoothed"
KEY_PLANE_PARAMETERS = "plane_parameters"
KEY_GLOBAL_HIST = "disp_derivative_histogram"


class SuperPixelDisparityPlaneSegmentationModule(Module):
    name = "SPPlaneSegmentation"

    def __init__(self, provider: PlaneParameterProvider, num_labels: int,
                 update_interval: int = 30, reset_interval: int = 10,
                 use_temporal_smoothing: bool = False, temporal_smoothing_distance: int = 3,
                 temporal_mode: str = "carried", warp_mode: str = "auto",
                 max_warp_y: int = 32, max_warp_x: int = 64):
        if temporal_mode not in pops.TEMPORAL_MODES:
            raise ValueError(f"unknown temporal_mode {temporal_mode!r}; expected one of "
                             f"{pops.TEMPORAL_MODES}")
        if warp_mode not in pops.WARP_MODES:
            raise ValueError(f"unknown warp_mode {warp_mode!r}; expected one of {pops.WARP_MODES}")
        self.provider = provider
        self.num_labels = num_labels
        self.update_interval = update_interval
        self.reset_interval = reset_interval
        self.temporal = use_temporal_smoothing
        self.distance = temporal_smoothing_distance
        self.temporal_mode = temporal_mode
        self.warp_mode = warp_mode
        self.max_warp_y = max_warp_y
        self.max_warp_x = max_warp_x
        self._running: np.ndarray | None = None

    def provides(self):
        return [KEY_PLANES, KEY_PLANES_UNSMOOTHED] if self.temporal else [KEY_PLANES]

    def requires(self):
        deps = [
            Dependency(KEY_SUPERPIXELS),
            Dependency(KEY_MAX_LABEL),
            Dependency(KEY_DERIVATIVE),
            Dependency(KEY_DERIVATIVE_HISTOGRAM),
        ]
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
        spec = TensorSpec((ctx.height, ctx.width), torch.uint8)
        return {k: spec for k in self.provides()}

    def initial_host_params(self, ctx: PipelineContext):
        return {"ranges": self.provider.get().ranges_array()}

    def host_fetch_keys(self):
        return [KEY_DERIVATIVE_HISTOGRAM]

    def host_fetch_reduce(self):
        return {KEY_DERIVATIVE_HISTOGRAM: "sum"}  # an additive histogram

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

    def host_update(self, ctx, frame_id, fetched, system=None):
        hist = fetched[KEY_DERIVATIVE_HISTOGRAM][:, 0].astype(np.int64)  # vertical
        if self._running is None:
            # The reference drops the first contribution.
            self._running = np.zeros_like(hist)
            snapshot = hist
        else:
            self._running += hist
            snapshot = self._running.copy()
        if system is not None:
            # `snapshot` is a new array every frame, never the running total.
            system.insert_global_data(KEY_GLOBAL_HIST + "_live", snapshot)
        if frame_id % (self.update_interval * self.reset_interval) == 1:
            self._running[:] = 0
        if frame_id % self.update_interval != 1:
            return None
        self.provider.update(snapshot)
        params = self.provider.get()
        if system is not None:
            system.insert_global_data(KEY_PLANE_PARAMETERS, params)
            system.insert_global_data(KEY_GLOBAL_HIST, snapshot)
        return {"ranges": params.ranges_array()}

    def compute(self, ctx, step, deps, state, params, variant):
        pixel_planes = pops.classify(deps[KEY_DERIVATIVE][..., 0], params["ranges"])
        if not self.temporal:
            planes = pops.superpixel_vote(pixel_planes, deps[KEY_SUPERPIXELS], self.num_labels)
            return {KEY_PLANES: planes}, {}
        if self.temporal_mode == "faithful":
            voted = pops.temporal_vote_from_history(
                pixel_planes, step, deps[KEY_OPTFLOW], self.distance, KEY_OPTFLOW,
                KEY_PLANES_UNSMOOTHED, current_weight=2, compare_unknown=True)
            planes = pops.superpixel_vote(voted, deps[KEY_SUPERPIXELS], self.num_labels)
            return {KEY_PLANES: planes, KEY_PLANES_UNSMOOTHED: pixel_planes}, {}
        prev = torch.where(step.frame_id > 1, step.history(KEY_PLANES_UNSMOOTHED, -1),
                           pops.WARP_INVALID)
        voted, warp_votes = pops.temporal_vote_warped(
            pixel_planes, prev, state["warp_votes"], deps[KEY_OPTFLOW],
            current_weight=2, compare_unknown=True, warp_mode=self.warp_mode,
            max_warp_y=self.max_warp_y, max_warp_x=self.max_warp_x,
        )
        planes = pops.superpixel_vote(voted, deps[KEY_SUPERPIXELS], self.num_labels)
        # The unsmoothed output is the raw per-pixel classification; the
        # temporal vote only feeds the superpixel tally.
        return ({KEY_PLANES: planes, KEY_PLANES_UNSMOOTHED: pixel_planes},
                {"warp_votes": warp_votes})

    # ------------------------------------------------------ spatial (sharded)

    def spatial_row_dims(self, ctx):
        # warp_votes stacks the temporal distance ahead of the row axis.
        return {"warp_votes": 1}

    def spatial_validate(self, ctx, n, h_local):
        if self.temporal and self.temporal_mode == "faithful":
            raise ValueError(
                "spatial mode supports temporal_mode='carried' only (the faithful "
                "K-gather mode would need K flow-history halos)"
            )
        if self.temporal and self.max_warp_y > h_local:
            logging.getLogger("cart.spatial").warning(
                "spatial mode clamps max_warp_y %d -> %d (the halo cannot exceed one "
                "%d-row shard)", self.max_warp_y, h_local, h_local,
            )

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        """Sharded vote chain: `max_warp_y`-row halos of the vote inputs,
        WARP_INVALID at the global borders, and always the 'select' warp,
        whose displacement bound equals the halo depth, so every in-bound
        source row is present locally and the result is the full frame's
        (with warp_mode='select' there) for any shard count.  The per-label
        tally counts core rows once, psum'd."""
        pixel_planes = pops.classify(deps[KEY_DERIVATIVE][..., 0], params["ranges"])
        if not self.temporal:
            planes = pops.superpixel_vote(pixel_planes, deps[KEY_SUPERPIXELS], self.num_labels,
                                          psum=sp.psum)
            return {KEY_PLANES: planes}, {}
        ry = min(self.max_warp_y, sp.h_local)
        prev = torch.where(step.frame_id > 1, step.history(KEY_PLANES_UNSMOOTHED, -1),
                           pops.WARP_INVALID)
        inv = pops.WARP_INVALID
        votes_ext = sp.exchange(state["warp_votes"].transpose(0, 1), ry, ry, fill=inv)
        voted_ext, warp_ext = pops.temporal_vote_warped(
            sp.exchange(pixel_planes, ry, ry, fill=pops.UNKNOWN),
            sp.exchange(prev, ry, ry, fill=inv),
            votes_ext.transpose(0, 1),
            sp.exchange(deps[KEY_OPTFLOW], ry, ry, fill=0),
            current_weight=2, compare_unknown=True, warp_mode="select",
            max_warp_y=ry, max_warp_x=self.max_warp_x,
        )
        voted = voted_ext[ry : ry + sp.h_local]
        planes = pops.superpixel_vote(voted, deps[KEY_SUPERPIXELS], self.num_labels,
                                      psum=sp.psum)
        return ({KEY_PLANES: planes, KEY_PLANES_UNSMOOTHED: pixel_planes},
                {"warp_votes": warp_ext[:, ry : ry + sp.h_local].contiguous()})
