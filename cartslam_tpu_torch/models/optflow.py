"""ImageOpticalFlowModule (counterpart of cartslam_tpu/models/optflow.py).

Flow between the current and the previous left image.  The previous gray
frame lives in module state; frame 1 emits zero flow.  Output: int16
[H, W, 2] in S10.5 fixed point, current -> previous.

The JAX module's height-sharded knobs (``spatial_mode``, ``spatial_halo``)
belong to the spatial mode, which is not ported yet.
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
                 base_level: int = 1, fine_refine: int = 1, med_passes: int = 2):
        self.image_size = image_size
        self.levels = levels
        self.search = search
        self.refine = refine
        self.base_level = base_level
        self.fine_refine = fine_refine
        self.med_passes = med_passes

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

    def compute(self, ctx, step, deps, state, params, variant):
        left = step.frame["left"]
        gray = left if ctx.grayscale else color.bgr_to_gray(left)
        if step.frame_id > 1:
            flow = fops.dense_flow(
                gray, state["prev_gray"], levels=self.levels, search=self.search,
                refine=self.refine, base_level=self.base_level,
                fine_refine=self.fine_refine, med_passes=self.med_passes,
            )
            out = fops.to_s10_5(flow)
        else:  # no previous frame yet
            out = torch.zeros((ctx.height, ctx.width, 2), dtype=torch.int16, device=gray.device)
        return {KEY_OPTFLOW: out}, {"prev_gray": gray}
