"""SuperPixelModule (counterpart of cartslam_tpu/models/superpixels.py).

The label image lives in module state.  It resets to the block grid every
`reset_iterations` frames; `initial_iterations` sweeps run on frame 1 and on
reset frames, `iterations` otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import color
from ..ops import superpixels as spops
from ..runtime.module import Dependency, Module, PipelineContext, TensorSpec

KEY_SUPERPIXELS = "superpixels"
KEY_MAX_LABEL = "superpixels_max_label"
KEY_DERIVATIVE = "disparity_derivative"


class SuperPixelModule(Module):
    name = "SuperPixelDetect"

    def __init__(self, image_size: tuple[int, int], initial_iterations: int = 18,
                 iterations: int = 6, block_size: int = 12, reset_iterations: int = 64,
                 direct_clique_cost: float = 0.5,
                 diagonal_clique_cost: float = 0.5 / np.sqrt(2),
                 compactness_weight: float = 0.1,
                 progressive_compactness_cost: float = 0.0, image_weight: float = 1.5,
                 disparity_weight: float = 1.0, relax_phases: int = 1,
                 stats_refresh: str = "frame"):
        if block_size < 1:
            raise ValueError("blockSize must be more than 1")
        if direct_clique_cost < 0:
            raise ValueError("directCliqueCost must be non-negative")
        if compactness_weight < 0 or image_weight < 0 or disparity_weight < 0:
            raise ValueError("weight must be non-negative")
        if relax_phases != 1 or stats_refresh != "frame":
            raise ValueError(
                f"superpixels with relax_phases={relax_phases}, "
                f"stats_refresh={stats_refresh!r} is not ported yet"
            )
        self.image_size = image_size
        self.initial_iterations = initial_iterations
        self.iterations = iterations
        self.block_size = block_size
        self.reset_iterations = reset_iterations
        self.direct_clique_cost = direct_clique_cost
        self.diagonal_clique_cost = diagonal_clique_cost
        self.compactness_weight = compactness_weight
        self.progressive_compactness_cost = progressive_compactness_cost
        self.image_weight = image_weight
        self.disparity_weight = disparity_weight

        h, w = image_size
        bx = -(-w // block_size)
        by = -(-h // block_size)
        # maxLabelId = nBlocksX * nBlocksY; stat tables hold maxLabelId + 1.
        self.max_label_id = bx * by
        self.num_labels = self.max_label_id + 1

    def provides(self):
        return [KEY_SUPERPIXELS, KEY_MAX_LABEL]

    def requires(self):
        if self.disparity_weight > 0:
            return [Dependency(KEY_DERIVATIVE)]
        return []

    def output_spec(self, ctx: PipelineContext):
        return {
            KEY_SUPERPIXELS: TensorSpec((ctx.height, ctx.width), torch.int32),
            KEY_MAX_LABEL: TensorSpec((), torch.int32),
        }

    def _grid(self, ctx):
        labels, _ = spops.block_init_labels(
            ctx.height, ctx.width, self.block_size, self.block_size, ctx.device
        )
        return labels

    def init_state(self, ctx: PipelineContext):
        return {"labels": self._grid(ctx)}

    def variant(self, frame_id: int) -> str:
        if frame_id == 1:
            return "initial"
        if frame_id % self.reset_iterations == 0:
            return "reset"
        return "normal"

    def compute(self, ctx, step, deps, state, params, variant):
        left = step.frame["left"]
        if ctx.grayscale:
            img = left[..., None].to(torch.float32)
            img_channels = 1
        else:
            img = color.bgr_to_ycrcb(left).to(torch.float32)
            img_channels = 3

        # Gaussian specs align positionally with feature_data; compactness
        # goes last (its data is the implicit pixel coordinates).
        feature_data = []
        specs = []
        if self.disparity_weight > 0:
            feature_data.append(deps[KEY_DERIVATIVE].to(torch.float32))
            specs.append(spops.FeatureSpec("gaussian", self.disparity_weight, 2))
        feature_data.append(img)
        specs.append(spops.FeatureSpec("gaussian", self.image_weight, img_channels))
        specs.append(spops.FeatureSpec(
            "compactness", self.compactness_weight, 2, self.progressive_compactness_cost
        ))

        labels = self._grid(ctx) if variant == "reset" else state["labels"]
        iters = (
            self.initial_iterations if variant in ("initial", "reset") else self.iterations
        )
        labels = spops.relax(
            labels, feature_data, specs, self.num_labels, iters,
            self.direct_clique_cost, self.diagonal_clique_cost,
        )
        outputs = {
            KEY_SUPERPIXELS: labels,
            KEY_MAX_LABEL: torch.tensor(self.max_label_id, dtype=torch.int32, device=ctx.device),
        }
        return outputs, {"labels": labels}
