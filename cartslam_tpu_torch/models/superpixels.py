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
        if relax_phases < 1:
            raise ValueError("relax_phases must be >= 1")
        if stats_refresh not in ("frame", "phase"):
            raise ValueError(f"unknown stats_refresh {stats_refresh!r}")
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
        # relax_phases: checkerboard sub-steps per sweep; stats_refresh:
        # 'frame' keeps a call's label statistics fixed, 'phase' re-tallies
        # them after every sub-step (the reference's incremental semantics).
        self.relax_phases = relax_phases
        self.stats_refresh = stats_refresh

        h, w = image_size
        bx = -(-w // block_size)
        by = -(-h // block_size)
        # maxLabelId = nBlocksX * nBlocksY; stat tables hold maxLabelId + 1.
        self.max_label_id = bx * by
        self.num_labels = self.max_label_id + 1
        self._max_label: tuple | None = None  # (device, int32 scalar on it)

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

    def _features(self, ctx, step, deps, extend=lambda x: x):
        """(feature_data, specs): gaussian specs align positionally with
        feature_data; compactness goes last (its data is the implicit pixel
        coordinates).  `extend` adds the spatial mode's halo rows."""
        left = step.frame["left"]
        if ctx.grayscale:
            img = left[..., None].to(torch.float32)
            img_channels = 1
        else:
            img = color.bgr_to_ycrcb(left).to(torch.float32)
            img_channels = 3
        feature_data = []
        specs = []
        if self.disparity_weight > 0:
            feature_data.append(extend(deps[KEY_DERIVATIVE].to(torch.float32)))
            specs.append(spops.FeatureSpec("gaussian", self.disparity_weight, 2))
        feature_data.append(extend(img))
        specs.append(spops.FeatureSpec("gaussian", self.image_weight, img_channels))
        specs.append(spops.FeatureSpec(
            "compactness", self.compactness_weight, 2, self.progressive_compactness_cost
        ))
        return feature_data, specs

    def _iterations(self, variant) -> int:
        return self.initial_iterations if variant in ("initial", "reset") else self.iterations

    def _outputs(self, ctx, labels):
        # The constant is made once (a fill on the device), not every step.
        if self._max_label is None or self._max_label[0] != ctx.device:
            self._max_label = (ctx.device, torch.full((), self.max_label_id,
                                                      dtype=torch.int32, device=ctx.device))
        return {KEY_SUPERPIXELS: labels, KEY_MAX_LABEL: self._max_label[1]}, {"labels": labels}

    def compute(self, ctx, step, deps, state, params, variant):
        feature_data, specs = self._features(ctx, step, deps)
        labels = self._grid(ctx) if variant == "reset" else state["labels"]
        labels = spops.relax(
            labels, feature_data, specs, self.num_labels, self._iterations(variant),
            self.direct_clique_cost, self.diagonal_clique_cost,
            phases=self.relax_phases, stats_refresh=self.stats_refresh,
        )
        return self._outputs(ctx, labels)

    # ------------------------------------------------------ spatial (sharded)

    def spatial_validate(self, ctx, n, h_local):
        ph = self.relax_phases
        for it, name in ((self.iterations, "iterations"),
                         (self.initial_iterations, "initial_iterations")):
            if it * ph > h_local:
                raise ValueError(
                    f"superpixels {name}*phases={it * ph} exceeds the {h_local}-row shard"
                )

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp):
        """Sharded contour relaxation: `iterations * phases`-row halos (a
        label moves at most one row per sub-step) and psum'd label moments,
        exact in both stats modes ('phase' psums every re-tally).  Halo
        labels at the global edges are -1, which relax treats as the image
        edge."""
        iters = self._iterations(variant)
        halo = iters * self.relax_phases
        feature_data, specs = self._features(
            ctx, step, deps, extend=lambda x: sp.exchange(x, halo, halo))
        # On a reset frame, the global block grid restricted to this shard.
        labels = sp.slice_rows(self._grid(ctx)) if variant == "reset" else state["labels"]
        labels_ext = spops.relax(
            sp.exchange(labels, halo, halo, fill=-1), feature_data, specs, self.num_labels,
            iters, self.direct_clique_cost, self.diagonal_clique_cost,
            phases=self.relax_phases, stats_refresh=self.stats_refresh,
            row_offset=sp.row0 - halo, global_h=ctx.height, halo_rows=(halo, halo),
            psum=sp.psum,
        )
        return self._outputs(ctx, labels_ext[halo : halo + sp.h_local])
