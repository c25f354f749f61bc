"""Quality metrics against the synthetic source's exact ground truth
(counterpart of cartslam_tpu/utils/quality.py; numpy only).

The reference's contour relaxation can only be matched metric-wise, not
bit-wise, so these are the standard superpixel metrics (boundary recall,
under-segmentation error), the flow's endpoint error and the plane labels'
accuracy, scored against ``SyntheticDataSource.ground_truth_regions`` /
``ground_truth_flow`` / ``ground_truth_disparity``.
"""

from __future__ import annotations

import numpy as np


def _boundaries(labels: np.ndarray) -> np.ndarray:
    """4-neighborhood boundary mask of a label image."""
    b = np.zeros(labels.shape, bool)
    b[:-1, :] |= labels[:-1, :] != labels[1:, :]
    b[1:, :] |= labels[1:, :] != labels[:-1, :]
    b[:, :-1] |= labels[:, :-1] != labels[:, 1:]
    b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    return b


def _dilate(mask: np.ndarray, r: int) -> np.ndarray:
    out = mask.copy()
    for _ in range(r):
        grown = out.copy()
        grown[1:, :] |= out[:-1, :]
        grown[:-1, :] |= out[1:, :]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


def boundary_recall(gt_regions: np.ndarray, sp_labels: np.ndarray, tol: int = 2) -> float:
    """Fraction of ground-truth boundary pixels within `tol` px of a
    superpixel boundary."""
    gt_b = _boundaries(gt_regions)
    sp_b = _dilate(_boundaries(sp_labels), tol)
    n = gt_b.sum()
    if n == 0:
        return 1.0
    return float((gt_b & sp_b).sum() / n)


def undersegmentation_error(gt_regions: np.ndarray, sp_labels: np.ndarray) -> float:
    """Bleeding of superpixels across ground-truth segments: for each
    segment S, the sum over the superpixels P meeting S of
    min(|P ∩ S|, |P − S|), over the image area (Neubert-Protzel; lower is
    better)."""
    total = 0.0
    sp = sp_labels.astype(np.int64)
    nsp = int(sp.max()) + 1
    area = np.bincount(sp.ravel(), minlength=nsp)
    for seg in np.unique(gt_regions):
        inter = np.bincount(sp.ravel(), weights=(gt_regions == seg).ravel(), minlength=nsp)
        overlap = inter > 0
        inside = inter[overlap]
        outside = area[overlap] - inside
        total += np.minimum(inside, outside).sum()
    return float(total / gt_regions.size)


def flow_epe(flow: np.ndarray, gt_flow: np.ndarray, mask: np.ndarray | None = None) -> float:
    """Mean endpoint error of a float flow field against the truth."""
    err = np.linalg.norm(flow.astype(np.float32) - gt_flow, axis=-1)
    if mask is not None:
        err = err[mask]
    return float(err.mean())


def plane_accuracy(planes: np.ndarray, gt_regions: np.ndarray, region_to_plane: dict[int, int],
                   margin: int = 4) -> float:
    """Classification accuracy on region interiors (`margin` px from the
    ground truth's edges)."""
    interior = ~_dilate(_boundaries(gt_regions), margin)
    correct = 0
    count = 0
    for region, plane in region_to_plane.items():
        m = (gt_regions == region) & interior
        count += m.sum()
        correct += (planes[m] == plane).sum()
    return float(correct / max(count, 1))
