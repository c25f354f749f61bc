"""Disparity modules (counterpart of cartslam_tpu/models/disparity.py).

ImageDisparityModule: gray conversion, census + SGM (kernel K1 on the
device; K5 on a row shard in the spatial mode), and the optional iterative
interpolation smoothing.  `block_size` is accepted for config parity; the
census window plays that role.

ZEDImageDisparityModule: converts an SDK-style float disparity measure to
the common int16 x(-16) fixed-point contract
(src/modules/disparity/disparity.cu:18-45; the scale is NEGATIVE because
ZED disparities are negative, so -16 lands them positive).
"""

from __future__ import annotations

import torch

from ..ops import color, stereo
from ..ops import disparity as dops
from ..runtime.module import Module, PipelineContext, TensorSpec

KEY_DISPARITY = "disparity"
DISPARITY_INVALID = -32768


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

    def spatial_validate(self, ctx, n, h_local):
        if h_local < 3:
            raise ValueError(f"SGM census needs a 3-row halo; shards have {h_local} rows")

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        """Row-shard SGM, bit-exact for any shard count: horizontal sweeps
        are row-local and the vertical sweeps run the split-scan carry
        chain (parallel/sgm_sharded.py)."""
        from ..parallel.sgm_sharded import sgm_disparity_sharded

        left, right = step.frame["left"], step.frame["right"]
        if not ctx.grayscale:
            left = color.bgr_to_gray(left)
            right = color.bgr_to_gray(right)
        disp = sgm_disparity_sharded(
            left, right, sp, min_disparity=self.min_disparity,
            num_disparities=self.num_disparities, p1=self.p1, p2=self.p2,
            uniqueness=self.uniqueness,
        )
        disp = _spatial_smooth(
            disp, sp, radius=self.smoothing_radius, iterations=self.smoothing_iterations,
            min_disparity=self.min_disparity * 16, max_disparity=ctx.width,
        )
        return {KEY_DISPARITY: disp}, {}


def _spatial_smooth(disp, sp, *, radius, iterations, min_disparity, max_disparity):
    """Sharded interpolation smoothing (exact): one halo exchange per
    iteration, since the full-frame op re-clamps its edge padding to the
    current border row every iteration.  Reach per iteration: radius-1 rows."""
    if radius <= 0:
        return disp
    hr = radius - 1
    for _ in range(iterations):
        d_ext = sp.exchange(disp, hr, hr)
        d_ext = dops.interpolate(d_ext, radius=radius, iterations=1,
                                 min_disparity=min_disparity, max_disparity=max_disparity)
        disp = d_ext[hr:-hr] if hr else d_ext
    return disp


def _from_measure(measure: torch.Tensor) -> torch.Tensor:
    """The SDK measure (float32, inf where invalid) as int16 x(-16):
    clipped to int16, truncated, non-finite values to -32768."""
    vals = torch.clamp(measure * -16.0, -32768, 32767)
    return torch.where(torch.isfinite(measure), vals.to(torch.int32),
                       torch.full((), DISPARITY_INVALID, dtype=torch.int32,
                                  device=measure.device)).to(torch.int16)


class ZEDImageDisparityModule(Module):
    name = "ZEDImageDisparity"

    def __init__(self, smoothing_radius: int = -1, smoothing_iterations: int = 5):
        self.smoothing_radius = smoothing_radius
        self.smoothing_iterations = smoothing_iterations

    def provides(self):
        return [KEY_DISPARITY]

    def output_spec(self, ctx: PipelineContext):
        return {KEY_DISPARITY: TensorSpec((ctx.height, ctx.width), torch.int16)}

    def compute(self, ctx, step, deps, state, params, variant):
        disp = _from_measure(step.frame["zed_disparity"])
        if self.smoothing_radius > 0:
            disp = dops.interpolate(disp, radius=self.smoothing_radius,
                                    iterations=self.smoothing_iterations, min_disparity=1,
                                    max_disparity=257)  # disparity.cu:110 passes (1, 256 + 1)
        return {KEY_DISPARITY: disp}, {}

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        """The conversion is pointwise, so the ZED chain height-shards too;
        only the smoothing stencil needs halos."""
        disp = _spatial_smooth(_from_measure(step.frame["zed_disparity"]), sp,
                               radius=self.smoothing_radius,
                               iterations=self.smoothing_iterations, min_disparity=1,
                               max_disparity=257)
        return {KEY_DISPARITY: disp}, {}
