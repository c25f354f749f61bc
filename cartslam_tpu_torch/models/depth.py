"""DepthModule (counterpart of models/depth.py)."""

from __future__ import annotations

import torch

from ..ops import depth as dops
from ..runtime.module import Dependency, Module, PipelineContext, TensorSpec

KEY_DISPARITY = "disparity"
KEY_DEPTH = "depth"


class DepthModule(Module):
    name = "Depth"

    def provides(self):
        return [KEY_DEPTH]

    def requires(self):
        return [Dependency(KEY_DISPARITY)]

    def output_spec(self, ctx: PipelineContext):
        return {KEY_DEPTH: TensorSpec((ctx.height, ctx.width, 3), torch.float32)}

    def compute(self, ctx, step, deps, state, params, variant):
        return {KEY_DEPTH: dops.reproject_to_3d(deps[KEY_DISPARITY], ctx.q_tensor)}, {}

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        # Pointwise in the disparity; only the reprojection's y needs the
        # shard's global row offset.
        return {KEY_DEPTH: dops.reproject_to_3d(deps[KEY_DISPARITY], ctx.q_tensor,
                                                row_offset=sp.row0)}, {}
