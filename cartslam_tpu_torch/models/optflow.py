"""ImageOpticalFlowModule (counterpart of cartslam_tpu/models/optflow.py).

Flow between the current and the previous left image.  The previous gray
frame lives in module state; frame 1 emits zero flow.  Output: int16
[H, W, 2] in S10.5 fixed point, current -> previous.

The height-sharded knobs (``spatial_mode``, ``spatial_halo``) are set from
a config's ``parallel`` block (config/registry.py).

Frame 1 is not a variant of its own: the flow runs against the zero
initial frame and ``torch.where`` on the device frame id keeps zeros, as
the JAX module's ``jnp.where`` does, so one captured step serves frame 1.
"""

from __future__ import annotations

import torch

from ..ops import color
from ..ops import optflow as fops
from ..runtime.module import Module, PipelineContext, TensorSpec

KEY_OPTFLOW = "optflow"


class ImageOpticalFlowModule(Module):
    name = "ImageOpticalFlow"

    def __init__(self, image_size, levels: int = 4, search: int = 4, refine: int = 2,
                 base_level: int = 1, fine_refine: int = 1, med_passes: int = 2,
                 spatial_mode: str = "global", spatial_halo: int = 46):
        self.image_size = image_size
        self.levels = levels
        self.search = search
        self.refine = refine
        self.base_level = base_level
        self.fine_refine = fine_refine
        self.med_passes = med_passes
        # Height-sharded mode only.  'global' (default): gather the gray
        # pair and run one full-image pyramid on every shard, bit-exact for
        # any shard count.  'sharded': per-shard apron pyramids of
        # spatial_halo rows, ~1/n of the flow work per shard, approximate
        # (the decimation grids shift at shard offsets that are not
        # multiples of the pyramid's scale).
        self.spatial_mode = spatial_mode
        self.spatial_halo = spatial_halo

    def provides(self):
        return [KEY_OPTFLOW]

    def output_spec(self, ctx: PipelineContext):
        return {KEY_OPTFLOW: TensorSpec((ctx.height, ctx.width, 2), torch.int16)}

    def init_state(self, ctx: PipelineContext):
        return {"prev_gray": torch.zeros((ctx.height, ctx.width), dtype=torch.uint8,
                                         device=ctx.device)}

    def flow_bound(self) -> int:
        return fops.flow_bound(self.levels, self.search, self.refine, self.base_level,
                               self.fine_refine)

    def _flow(self, cur, prev):
        return fops.dense_flow(
            cur, prev, levels=self.levels, search=self.search, refine=self.refine,
            base_level=self.base_level, fine_refine=self.fine_refine,
            med_passes=self.med_passes,
        )

    def compute(self, ctx, step, deps, state, params, variant):
        left = step.frame["left"]
        gray = left if ctx.grayscale else color.bgr_to_gray(left)
        out = fops.to_s10_5(self._flow(gray, state["prev_gray"]))
        out = torch.where(step.frame_id > 1, out, 0)  # no previous frame on frame 1
        return {KEY_OPTFLOW: out}, {"prev_gray": gray}

    def spatial_validate(self, ctx, n, h_local):
        if self.spatial_mode not in ("global", "sharded"):
            raise ValueError(f"unknown optflow spatial_mode {self.spatial_mode!r}")
        if self.spatial_mode == "sharded" and self.spatial_halo > h_local:
            raise ValueError(
                f"optflow spatial_halo={self.spatial_halo} exceeds the {h_local}-row shard"
            )

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        """prev_gray lives as row shards; the pyramid runs on the gathered
        full pair (bit-exact) or on a per-shard apron (spatial_mode)."""
        left = step.frame["left"]
        gray = left if ctx.grayscale else color.bgr_to_gray(left)
        # Every shard runs the same collectives on every frame, frame 1
        # included (its flow is masked to zeros below).
        if self.spatial_mode == "global":
            full = self._flow(sp.all_gather_rows(gray), sp.all_gather_rows(state["prev_gray"]))
            out = fops.to_s10_5(sp.slice_rows(full))
        else:
            fh = self.spatial_halo
            flow_ext = self._flow(sp.exchange(gray, fh, fh),
                                  sp.exchange(state["prev_gray"], fh, fh))
            out = fops.to_s10_5(flow_ext[fh : fh + sp.h_local])
        out = torch.where(step.frame_id > 1, out, 0)
        return {KEY_OPTFLOW: out}, {"prev_gray": gray}
