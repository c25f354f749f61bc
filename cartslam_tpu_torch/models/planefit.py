"""SuperPixelPlaneFitModule: greedy multi-plane RANSAC over superpixels
(counterpart of cartslam_tpu/models/planefit.py).

Reference: src/modules/planefit.cu:357-445.  The per-label plane fits and
the [plane x label] inlier counts are vectorized device calls
(utils/plane_math.py) on ``ctx.device``, on the module's own stream
(``HostModule.device_work``); only the small greedy adoption loop stays on
the host, with the JAX module's jittered-grid sampler
(``np.random.RandomState(0)``, one per module instance, consumed on the
same paths).

Differences from the reference, by design (as in the JAX module):
  * per-superpixel planes come from vectorized RANSAC, with
    fit_method='lsq' the deterministic closed-form alternative;
  * the reference's progress counter increments for VALID regions
    (planefit.cu:389-394), which makes the 90%-assigned stop trigger
    immediately on clean frames; excluded regions count as done instead.

Outputs the reference's plane_fit_data_t equivalent:
    planes_eq = {"planes": [P, 4] float, "assignments": [L] int}
(assignment 0 = unassigned, i>0 = planes[i-1], planefit.hpp:13-16).
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.module import Dependency, HostModule
from ..utils import plane_math

KEY_PLANES_EQ = "planes_eq"


def depth_validity(depth: torch.Tensor) -> torch.Tensor:
    """Pixels whose depth z is finite and in (0, 40]."""
    z = depth[..., 2]
    return torch.isfinite(z) & (z > 0.0) & (z <= 40.0)


def fit_planes(labels, depth, valid, num_labels, method, draws):
    """([L, 4] planes, [L] point counts) by RANSAC (util::segmentPlane's
    sampling robustness, plane.cpp:99-180, vectorized over every label) or
    by the closed-form least-squares fit ('lsq')."""
    if method == "ransac":
        return plane_math.ransac_label_planes(labels, depth, valid, num_labels, draws=draws)
    return plane_math.fit_label_planes(labels, depth, valid, num_labels)


class RansacDraws:
    """The RANSAC draws of one image size and device, made at first use:
    they depend on the shapes only (plane_math.ransac_draws)."""

    def __init__(self, num_labels: int):
        self.num_labels = num_labels
        self._key = None
        self._draws = None

    def get(self, num_pixels: int, device) -> dict[str, torch.Tensor]:
        key = (num_pixels, torch.device(device))
        if self._key != key:
            self._draws = plane_math.ransac_draws(num_pixels, self.num_labels, device=device)
            self._key = key
        return self._draws


class SuperPixelPlaneFitModule(HostModule):
    name = "PlaneFit"

    def __init__(self, num_labels: int, max_iters: int = 100, target: float = 0.9,
                 fit_method: str = "ransac"):
        self.num_labels = num_labels
        self.max_iters = max_iters
        self.target = target
        self.fit_method = fit_method
        self.rng = np.random.RandomState(0)
        self.draws = RansacDraws(num_labels)

    def requires(self):
        return [Dependency("superpixels"), Dependency("depth")]

    def provides_data(self):
        return [KEY_PLANES_EQ]

    def _sample_superpixels(self, labels, x_count=4, y_count=3):
        """Jittered-grid superpixel sampling (planefit.cu:329-355)."""
        h, w = labels.shape
        y_step = h // (y_count + 2)
        x_step = w // (x_count + 2)
        out = []
        for y in range(y_step, h, y_step):
            for x in range(x_step, w, x_step):
                xo = x + self.rng.randint(-x_step // 2, x_step // 2 + 1)
                yo = y + self.rng.randint(-y_step // 2, y_step // 2 + 1)
                if 0 <= xo < w and 0 <= yo < h:
                    out.append(int(labels[yo, xo]))
        return out

    def process(self, ctx, frame_id, frame, fetched, globals_):
        labels = fetched["superpixels"]
        L = self.num_labels
        dev = ctx.device
        with self.device_work(ctx):
            lab = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)
            depth = torch.from_numpy(np.ascontiguousarray(fetched["depth"])).to(dev)
            valid = depth_validity(depth)
            flat = lab.reshape(-1).long()
            count = torch.bincount(flat, minlength=L).numpy(force=True)
            invalid = torch.bincount(flat[~valid.reshape(-1)], minlength=L).numpy(force=True)
            draws = self.draws.get(lab.numel(), dev) if self.fit_method == "ransac" else None
            planes_all, npts = (t.numpy(force=True) for t in fit_planes(
                lab, depth, valid, L, self.fit_method, draws))
            valid_region = invalid < 0.5 * count

            assignments = np.zeros(L, np.int64)
            planes: list[np.ndarray] = []
            # Invalid regions count as excluded from the work (module docstring).
            done = int((~valid_region).sum())

            it = 0
            while done / L < self.target and it < self.max_iters:
                it += 1
                sample = self._sample_superpixels(labels)
                cands = [l for l in dict.fromkeys(sample)
                         if assignments[l] == 0 and valid_region[l] and npts[l] >= 16
                         and np.linalg.norm(planes_all[l]) > 0]
                if len(cands) <= 3:
                    continue
                local = planes_all[cands]
                inl = plane_math.count_plane_inliers_per_label(
                    lab, depth, valid, torch.from_numpy(local).to(dev), L,
                    threshold=0.02).numpy(force=True)  # [P, L]

                # attemptAssignment (planefit.cu:286-326): a label is
                # acceptable for a plane when inliers > 0.5 * pixelCount;
                # adopt the plane covering the most labels.
                eligible = (assignments == 0) & valid_region & (inl > 0.5 * np.maximum(count, 1))
                best = int(eligible.sum(axis=1).argmax())
                accept = np.where(eligible[best])[0]
                if len(accept) < 16:
                    continue
                planes.append(local[best])
                assignments[accept] = len(planes)
                done += len(accept)

        planes_eq = {"planes": np.array(planes) if planes else np.zeros((0, 4)),
                     "assignments": assignments}
        # Per-run data (planefit.hpp:9-16 provides planes_eq through the
        # promise store); globals_ keeps the latest copy for consumers
        # outside the retention window.
        globals_[KEY_PLANES_EQ] = planes_eq
        return {KEY_PLANES_EQ: planes_eq}
