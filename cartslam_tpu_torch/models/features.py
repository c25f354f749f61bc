"""ImageFeatureDetectorModule (counterpart of cartslam_tpu/models/features.py;
reference: src/modules/features.cpp).

ORB-style keypoints and descriptors on both stereo images (the reference
runs its detector on left and right via a visitor, features.cpp:20-25).
Output keys: 'features' float32 [2, K, 4] (x, y, score, level; score <= 0
marks an unused slot, the static-shape stand-in for the dynamic keypoint
vectors) and 'feature_descriptors' uint32 [2, K, 8].  A device module: on
the card the System captures it into the step's CUDA graph, so it reads
nothing back to the host; its constants (the BRIEF pattern, the resize
weights) are made at its first step and kept.
"""

from __future__ import annotations

import torch

from ..ops import color
from ..ops.features import OrbConstants, detect_orb_pyramid
from ..runtime.module import Module, PipelineContext, TensorSpec

KEY_FEATURES = "features"
KEY_DESCRIPTORS = "feature_descriptors"


class ImageFeatureDetectorModule(Module):
    name = "ImageFeatureDetector"

    def __init__(self, max_keypoints: int = 5000, threshold: int = 20, levels: int = 3):
        self.max_keypoints = max_keypoints
        self.threshold = threshold
        self.levels = levels
        self.consts = OrbConstants()

    def provides(self):
        return [KEY_FEATURES, KEY_DESCRIPTORS]

    def output_spec(self, ctx: PipelineContext):
        k = self.max_keypoints
        return {KEY_FEATURES: TensorSpec((2, k, 4), torch.float32),
                KEY_DESCRIPTORS: TensorSpec((2, k, 8), torch.uint32)}

    def compute(self, ctx, step, deps, state, params, variant):
        outs, descs = [], []
        for img in (step.frame["left"], step.frame["right"]):
            gray = img if ctx.grayscale else color.bgr_to_gray(img)
            kps, d = detect_orb_pyramid(gray, self.max_keypoints, self.threshold, self.levels,
                                        consts=self.consts)
            outs.append(kps)
            descs.append(d)
        return {KEY_FEATURES: torch.stack(outs, dim=0),
                KEY_DESCRIPTORS: torch.stack(descs, dim=0)}, {}
