"""Plane fitting math on the device (counterpart of cartslam_tpu/utils/
plane_math.py).

Closed-form least-squares plane from point moments, following the
determinant method the reference borrowed from ilikebigbits.com
(src/utils/plane.cpp:56-97), and a per-label RANSAC vectorized over all
labels and hypotheses.  The jnp code ports as torch ops, with two changes
of means and none of result:

  * Per-label sums are segmented sums over the pixels stably sorted by
    label (``torch.segment_reduce``), not a scatter-add: ``index_add_`` on
    float32 adds with atomics in no fixed order on the card, and the
    planes must be the same on two runs.  Within a label the pixels keep
    their order, so on the CPU the sums round as the JAX package's serial
    scatter does.
  * The random draws (``jax.random`` in the JAX package) come from
    ``ransac_draws``: the same bits from a numpy copy of Threefry
    (utils/threefry.py), made once and kept on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import threefry


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of 3, summed in order (as XLA's
    reduce of the squares)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def _dot3(p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """sum_c p[..., c] * a[..., c] over 3 components, in order."""
    return p[..., 0] * a[..., 0] + p[..., 1] * a[..., 1] + p[..., 2] * a[..., 2]


def plane_from_moments(n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz) -> torch.Tensor:
    """Least-squares plane [a,b,c,d] (unit normal) per label from moments.

    All args are [L]-shaped sums over each label's valid 3D points.
    Returns [L, 4]; rows with n < 3 or degenerate covariance are zeros
    (the reference's null-plane convention, plane.cpp:84-86).
    """
    n_safe = torch.clamp(n, min=1.0)
    cx, cy, cz = sx / n_safe, sy / n_safe, sz / n_safe
    # Central second moments (covariance * n).
    xx = sxx - sx * cx
    xy = sxy - sx * cy
    xz = sxz - sx * cz
    yy = syy - sy * cy
    yz = syz - sy * cz
    zz = szz - sz * cz

    det_x = yy * zz - yz * yz
    det_y = xx * zz - xz * xz
    det_z = xx * yy - xy * xy

    abc_x = torch.stack([det_x, xz * yz - xy * zz, xy * yz - xz * yy], -1)
    abc_y = torch.stack([xz * yz - xy * zz, det_y, xy * xz - yz * xx], -1)
    abc_z = torch.stack([xy * yz - xz * yy, xy * xz - yz * xx, det_z], -1)

    use_x = (det_x > det_y) & (det_x > det_z)
    use_y = (~use_x) & (det_y > det_z)
    abc = torch.where(use_x[..., None], abc_x, torch.where(use_y[..., None], abc_y, abc_z))

    norm = _norm3(abc)
    degenerate = (torch.maximum(torch.maximum(det_x, det_y), det_z) <= 0) | (norm == 0) | (n < 3)
    abc = abc / torch.clamp(norm, min=1e-20)[..., None]
    d = -(abc[..., 0] * cx + abc[..., 1] * cy + abc[..., 2] * cz)
    plane = torch.cat([abc, d[..., None]], dim=-1)
    return torch.where(degenerate[..., None], torch.zeros((), dtype=plane.dtype,
                                                          device=plane.device), plane)


def segment_sums(flat_labels: torch.Tensor, values: torch.Tensor, num_labels: int) -> torch.Tensor:
    """[L, C] per-label sums of values [N, C] (labels in [0, L)): a
    segmented reduction over the pixels stably sorted by label, so the
    result does not depend on the order atomics land in."""
    order = torch.sort(flat_labels, stable=True).indices
    lengths = torch.bincount(flat_labels, minlength=num_labels)
    return torch.segment_reduce(values[order], "sum", lengths=lengths, axis=0)


def _finite_points(points: torch.Tensor):
    """(points [N, 3] float32 with non-finite points zeroed, finite mask [N])."""
    p = points.reshape(-1, 3).to(torch.float32)
    finite = torch.isfinite(p).all(dim=-1)
    return torch.where(finite[:, None], p, torch.zeros((), device=p.device)), finite


def label_point_moments(labels, points, valid, num_labels) -> dict[str, torch.Tensor]:
    """Per-label moments of valid 3D points.

    labels int [H,W]; points float [H,W,3]; valid bool [H,W].
    Returns dict of [L] tensors: n, sx, sy, sz, sxx, sxy, sxz, syy, syz, szz.
    Non-finite points (reprojection at disparity 0, the ZED inf fill) are
    excluded from validity and zeroed, since inf * 0 would poison a sum.
    """
    flat = labels.reshape(-1).long()
    p, finite = _finite_points(points)
    w = (valid.reshape(-1) & finite).to(torch.float32)
    x, y, z = p.unbind(-1)
    cols = torch.stack([torch.ones_like(w), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z],
                       dim=-1) * w[:, None]
    sums = segment_sums(flat, cols, num_labels).unbind(-1)
    names = ("n", "sx", "sy", "sz", "sxx", "sxy", "sxz", "syy", "syz", "szz")
    return dict(zip(names, sums))


def fit_label_planes(labels, points, valid, num_labels):
    """([L, 4] least-squares plane per label over its valid points, [L] counts)."""
    m = label_point_moments(labels, points, valid, num_labels)
    return plane_from_moments(m["n"], m["sx"], m["sy"], m["sz"], m["sxx"], m["sxy"], m["sxz"],
                              m["syy"], m["syz"], m["szz"]), m["n"]


def _plane_from_3pts(p0, p1, p2) -> torch.Tensor:
    """Plane [*, 4] (unit normal) through 3 points; zeros when collinear."""
    u, v = p1 - p0, p2 - p0
    # The cross product as separate products and differences (one fused
    # kernel on the card could contract them into FMAs).
    n = torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                     u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                     u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)
    norm = _norm3(n)[..., None]
    nn = n / torch.clamp(norm, min=1e-20)
    d = -(nn[..., 0] * p0[..., 0] + nn[..., 1] * p0[..., 1] + nn[..., 2] * p0[..., 2])
    plane = torch.cat([nn, d[..., None]], dim=-1)
    return torch.where(norm > 1e-12, plane, torch.zeros((), device=plane.device))


def ransac_draws(num_pixels: int, num_labels: int, hypotheses: int = 16, seed: int = 0,
                 device="cpu") -> dict[str, torch.Tensor]:
    """The random bits of ``label_point_table`` and ``ransac_label_planes``,
    as the JAX package draws them: ``mix`` int64 [N] in [0, 2^20) (key
    PRNGKey(0)) and ``hyp`` int64 [hypotheses, L, 3] in [0, 2^30) (one
    key a hypothesis from split(PRNGKey(seed), hypotheses)).  They depend
    on the shapes and the seed only, so a caller makes them once."""
    keys = threefry.split(threefry.prng_key(seed), hypotheses)
    hyp = np.stack([threefry.randint(k, (num_labels, 3), 0, 1 << 30) for k in keys])
    return {"mix": _mix_draw(num_pixels, device),
            "hyp": torch.from_numpy(hyp).long().to(device)}


def _mix_draw(num_pixels: int, device) -> torch.Tensor:
    return torch.from_numpy(threefry.randint(threefry.prng_key(0), (num_pixels,), 0,
                                             1 << 20)).long().to(device)


def label_point_table(labels, points, valid, num_labels, sample_k, mix=None):
    """Up to `sample_k` valid 3D points per label: [L, K, 3] + counts [L].

    One device sort groups pixels by label (random-keyed within a label by
    `mix`, so the K kept points are a uniform sample; ties keep pixel
    order, as JAX's lexsort does); per-label offsets come from a left
    searchsorted, then one [L, K] gather reads the table (the static-shape
    replacement for the reference's ragged per-superpixel point vectors,
    planefit.cu:369-381).
    """
    n = labels.numel()
    dev = labels.device
    flat_lab = labels.reshape(-1).long()
    p, finite = _finite_points(points)
    ok = valid.reshape(-1) & finite
    # Invalid pixels sort to a sentinel label past the end.
    lab = torch.where(ok, flat_lab, torch.full((), num_labels, dtype=torch.long, device=dev))
    if mix is None:
        mix = _mix_draw(n, dev)
    order = torch.sort((lab << 20) | mix, stable=True).indices
    lab_sorted = lab[order]

    starts = torch.searchsorted(lab_sorted, torch.arange(num_labels + 1, device=dev))
    counts = (starts[1:] - starts[:-1]).to(torch.int32)
    slots = torch.arange(sample_k, device=dev)
    idx = torch.clamp(starts[:-1, None] + slots[None, :], max=n - 1)
    slot_valid = slots[None, :] < counts[:, None]
    pix = order[idx]  # [L, K] pixel ids
    table = torch.where(slot_valid[..., None], p[pix], torch.zeros((), device=dev))
    return table, counts


def ransac_label_planes(labels, points, valid, num_labels, *, hypotheses: int = 16,
                        sample_k: int = 64, threshold: float = 0.02, min_points: int = 3,
                        seed: int = 0, draws: dict[str, torch.Tensor] | None = None):
    """Per-label RANSAC plane fit, all labels x all hypotheses at once.

    The mapping of util::segmentPlane (plane.cpp:99-180): H independent
    3-point hypotheses per label, inliers scored on the label's K-point
    sample table, the winner refit with the closed-form moment solve over
    ALL of the label's inlier pixels.  The reference's probabilistic early
    break becomes a fixed hypothesis budget.  `draws`: ``ransac_draws`` of
    these shapes (made here when None).

    Returns ([L, 4] planes, [L] valid-point counts).
    """
    dev = labels.device
    if draws is None:
        draws = ransac_draws(labels.numel(), num_labels, hypotheses, seed, dev)
    table, counts = label_point_table(labels, points, valid, num_labels, sample_k,
                                      mix=draws["mix"])
    kmax = torch.clamp(torch.clamp(counts, max=sample_k), min=1).long()
    r = draws["hyp"]  # [H, L, 3]
    if r.shape != (hypotheses, num_labels, 3):
        raise ValueError(f"draws of shape {tuple(r.shape)}, expected ({hypotheses}, "
                         f"{num_labels}, 3)")

    # Three DISTINCT sample indices per label via the shifted-rank trick
    # (uniform without replacement), the reference's RandomSampler contract
    # (src/utils/random.cpp:4-23); all hypotheses at once.
    a = r[..., 0] % kmax
    b = r[..., 1] % torch.clamp(kmax - 1, min=1)
    b = b + (b >= a).long()
    c = r[..., 2] % torch.clamp(kmax - 2, min=1)
    c = c + (c >= torch.minimum(a, b)).long()
    c = c + (c >= torch.maximum(a, b)).long()
    sel = torch.stack([a, b, c], dim=-1) % kmax[:, None]  # [H, L, 3]
    lab_idx = torch.arange(num_labels, device=dev)[None, :, None]
    pts = table[lab_idx, sel]  # [H, L, 3, 3]
    planes_h = _plane_from_3pts(pts[..., 0, :], pts[..., 1, :], pts[..., 2, :])  # [H, L, 4]
    dist = torch.abs(_dot3(table[None], planes_h[:, :, None, :3]) + planes_h[..., 3:4])
    slot = torch.arange(sample_k, device=dev)[None, :] < counts[:, None]
    score = ((dist < threshold) & slot).sum(dim=-1)
    # A degenerate (collinear/duplicate-sample) hypothesis is the zero plane
    # whose distance is 0 everywhere: it would beat every real plane in the
    # argmax.  The reference skips zero-norm models (plane.cpp:140-142).
    nondeg = _norm3(planes_h[..., :3]) > 1e-12
    scores_h = torch.where(nondeg, score, torch.full((), -1, dtype=score.dtype, device=dev))
    best_h = torch.argmax(scores_h, dim=0)  # the first maximum, as jnp.argmax
    best_plane = planes_h[best_h, torch.arange(num_labels, device=dev)]  # [L, 4]

    # Final refit on inliers over ALL pixels (plane.cpp:163-180): validity
    # restricted to points within `threshold` of the winning hypothesis.
    # The refit keeps the covariance method's own orientation, consistent
    # across labels like the reference's getPlaneFromPoints(inliers).
    lab = labels.long()
    per_pix = best_plane[lab]  # [H, W, 4]
    pf = points.to(torch.float32)
    dist = torch.abs(_dot3(pf, per_pix[..., :3]) + per_pix[..., 3])
    degenerate = _norm3(best_plane[:, :3]) < 1e-6
    inlier = valid & (dist < threshold) & ~degenerate[lab]
    refit, n_in = fit_label_planes(labels, points, inlier, num_labels)
    ok = (counts >= min_points) & (n_in >= 3) & ~degenerate
    return torch.where(ok[:, None], refit, torch.zeros((), device=dev)), counts


def count_plane_inliers_per_label(labels, points, valid, planes, num_labels,
                                  threshold) -> torch.Tensor:
    """Inlier counts [P, L] int32: per plane, per label, valid points within
    `threshold` of the plane (calculateRegionDistance, planefit.cu:84-138)."""
    p = points.reshape(-1, 3).to(torch.float32)
    flat = labels.reshape(-1).long()
    w = valid.reshape(-1)
    a = planes[:, :3].to(torch.float32)
    denom = torch.clamp(_norm3(a), min=1e-20)
    dist = torch.abs(_dot3(p[None], a[:, None]) + planes[:, 3:4].float()) / denom[:, None]
    inl = (dist < threshold) & w[None]  # [P, N]
    num_planes = planes.shape[0]
    key = torch.arange(num_planes, device=p.device)[:, None] * num_labels + flat[None]
    return torch.bincount(key[inl], minlength=num_planes * num_labels).reshape(
        num_planes, num_labels).to(torch.int32)
