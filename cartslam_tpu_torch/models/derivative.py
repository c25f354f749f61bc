"""ImageDisparityDerivativeModule (counterpart of models/derivative.py)."""

from __future__ import annotations

import torch

from ..ops import derivative as dops
from ..runtime.module import Dependency, Module, PipelineContext, TensorSpec

KEY_DISPARITY = "disparity"
KEY_DERIVATIVE = "disparity_derivative"
KEY_DERIVATIVE_HISTOGRAM = "disparity_derivative_histogram"


class ImageDisparityDerivativeModule(Module):
    name = "ImageDisparityDerivative"

    def provides(self):
        return [KEY_DERIVATIVE, KEY_DERIVATIVE_HISTOGRAM]

    def requires(self):
        return [Dependency(KEY_DISPARITY)]

    def output_spec(self, ctx: PipelineContext):
        return {
            KEY_DERIVATIVE: TensorSpec((ctx.height, ctx.width, 2), torch.int16),
            KEY_DERIVATIVE_HISTOGRAM: TensorSpec((256, 2), torch.int32),
        }

    def compute(self, ctx, step, deps, state, params, variant):
        deriv, hist = dops.directional_derivatives(deps[KEY_DISPARITY])
        return {KEY_DERIVATIVE: deriv, KEY_DERIVATIVE_HISTOGRAM: hist}, {}

    def spatial_row_dims(self, ctx):
        # The histogram is a global reduction (psum'd), never row-split; at
        # ctx.height == 256 shape inference would take its bin axis for rows.
        return {KEY_DERIVATIVE_HISTOGRAM: None}

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        """2-row edge-duplicated halo (the +-2 stencil's clamp): exact.  The
        histogram re-tallies the core rows only, then psums: the int16
        output encodes the raw difference exactly wherever it is valid, and
        both paths drop values outside [-128, 127]."""
        d_ext = sp.exchange(deps[KEY_DISPARITY], 2, 2)
        deriv_ext, _ = dops.directional_derivatives(d_ext)
        deriv = deriv_ext[2:-2]
        hist = torch.stack([
            dops.hist256(deriv[..., c].to(torch.int32), deriv[..., c] != dops.DERIVATIVE_INVALID)
            for c in range(2)
        ], dim=-1)
        return {KEY_DERIVATIVE: deriv, KEY_DERIVATIVE_HISTOGRAM: sp.psum(hist)}, {}
