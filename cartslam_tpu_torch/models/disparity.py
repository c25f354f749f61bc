"""ImageDisparityModule (counterpart of cartslam_tpu/models/disparity.py).

Gray conversion, census + SGM (kernel K1 on the device), and the optional
iterative interpolation smoothing.  `block_size` is accepted for config
parity; the census window plays that role.
"""

from __future__ import annotations

import torch

from ..ops import color, stereo
from ..ops import disparity as dops
from ..runtime.module import Module, PipelineContext, TensorSpec

KEY_DISPARITY = "disparity"


class ImageDisparityModule(Module):
    name = "ImageDisparity"

    def __init__(self, image_size: tuple[int, int], min_disparity: int = 4,
                 num_disparities: int = 256, block_size: int = 3,
                 smoothing_radius: int = -1, smoothing_iterations: int = 5,
                 p1: int = 10, p2: int = 120, uniqueness: int = 12):
        self.image_size = image_size
        self.min_disparity = min_disparity
        self.num_disparities = num_disparities
        self.block_size = block_size
        self.smoothing_radius = smoothing_radius
        self.smoothing_iterations = smoothing_iterations
        self.p1 = p1
        self.p2 = p2
        self.uniqueness = uniqueness

    def provides(self):
        return [KEY_DISPARITY]

    def output_spec(self, ctx: PipelineContext):
        return {KEY_DISPARITY: TensorSpec((ctx.height, ctx.width), torch.int16)}

    def compute(self, ctx, step, deps, state, params, variant):
        left, right = step.frame["left"], step.frame["right"]
        if not ctx.grayscale:
            left = color.bgr_to_gray(left)
            right = color.bgr_to_gray(right)
        disp = stereo.sgm_disparity(
            left, right, min_disparity=self.min_disparity,
            num_disparities=self.num_disparities, p1=self.p1, p2=self.p2,
            uniqueness=self.uniqueness,
        )
        if self.smoothing_radius > 0:
            # maxDisparity bound = image width: the reference's (quirky)
            # ImageDisparityModule ctor (disparity.hpp:28-29).
            disp = dops.interpolate(
                disp, radius=self.smoothing_radius,
                iterations=self.smoothing_iterations,
                min_disparity=self.min_disparity * 16, max_disparity=ctx.width,
            )
        return {KEY_DISPARITY: disp}, {}
