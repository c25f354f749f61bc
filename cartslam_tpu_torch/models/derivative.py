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
