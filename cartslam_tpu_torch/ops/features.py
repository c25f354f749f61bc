"""ORB-style feature detection: FAST-9 corners + rotated BRIEF (counterpart
of cartslam_tpu/ops/features.py).

The reference uses cv::cuda::ORB with 5000 keypoints
(src/modules/features.cpp:8,48-66).  Static shapes: a fixed top-K of NMS'd
FAST corners (invalid slots have score 0), orientation by intensity
centroid, and a 256-bit rotated-BRIEF descriptor packed into 8 uint32
words.  The jnp code ports as torch ops on the device, with no read back
to the host, so the step that runs it can be captured.  Where the two
frameworks differ:

  * ``jax.lax.top_k`` breaks ties by the lower index and ``torch.topk``
    does not, so the top K come from a stable descending sort;
  * ``jax.image.resize(..., "linear")`` antialiases when it downsamples:
    its weight matrices are computed here in numpy as JAX computes them
    (``resize_weights``, a copy of jax/_src/image/scale.py
    compute_weight_mat) and applied as two float32 products.  The products
    round in another order than JAX's einsum, so a few level pixels may
    land one gray level apart;
  * the orientation's arctan2, cos and sin round differently in the two
    libraries, which can move a BRIEF sample by a pixel where a rotated
    coordinate lands on .5.
"""

from __future__ import annotations

import numpy as np
import torch

from .stereo import pad_edge

# Bresenham circle of radius 3 (FAST-9/16), standard order, as (x, y).
_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    np.int32,
)

_PATCH = 31  # BRIEF sampling patch
_HALF = _PATCH // 2


def _brief_pattern(seed: int = 7, n: int = 256) -> np.ndarray:
    """[n, 4] (x1, y1, x2, y2) gaussian test pattern inside the patch."""
    rng = np.random.RandomState(seed)
    return np.clip(np.round(rng.randn(n, 4) * _PATCH / 5.0), -_HALF + 1,
                   _HALF - 1).astype(np.int32)


_PATTERN = _brief_pattern()


def _shifted(padded: torch.Tensor, pad: int, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """x[clamp(y + dy), clamp(x + dx)] from x edge-padded by `pad`."""
    return padded[pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def fast_score(gray: torch.Tensor, threshold: int = 20) -> torch.Tensor:
    """FAST-9/16 corner score map int32 (0 where not a corner)."""
    g = gray.to(torch.int32)
    h, w = g.shape
    gp = pad_edge(g, 3, 3)
    ring = torch.stack([_shifted(gp, 3, int(dy), int(dx), h, w) for dx, dy in _CIRCLE], 0)
    bright = ring > (g + threshold)[None]
    dark = ring < (g - threshold)[None]

    def has_run9(mask):
        dbl = torch.cat([mask, mask], dim=0)  # circular
        run = dbl[0:16]
        for k in range(1, 9):
            run = run & dbl[k:k + 16]
        return run.any(dim=0)

    corner = has_run9(bright) | has_run9(dark)
    score = torch.clamp(torch.abs(ring - g[None]) - threshold, min=0).sum(dim=0, dtype=torch.int32)
    return torch.where(corner, score, torch.zeros((), dtype=torch.int32, device=g.device))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    h, w = score.shape
    sp = pad_edge(score, 1, 1)
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = torch.maximum(m, _shifted(sp, 1, dy, dx, h, w))
    return torch.where(score >= m, score, torch.zeros((), dtype=score.dtype,
                                                      device=score.device))


class OrbConstants:
    """The detector's device constants, made at first use and kept: the
    BRIEF pattern and the resize weights of each level shape.  A caller
    that runs the detector every frame (the module) keeps one, so a warm
    step copies nothing from the host."""

    def __init__(self):
        self._made: dict = {}

    def _get(self, key, make):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    def pattern(self, device) -> torch.Tensor:
        device = torch.device(device)
        return self._get(("pattern", device),
                         lambda: torch.from_numpy(_PATTERN).float().to(device))

    def resize(self, device, h, w, lh, lw) -> tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device)
        return self._get(("resize", device, h, w, lh, lw), lambda: (
            torch.from_numpy(resize_weights(h, lh)).to(device),
            torch.from_numpy(resize_weights(w, lw)).to(device)))


def detect_orb(gray: torch.Tensor, max_keypoints: int = 5000, threshold: int = 20,
               consts: OrbConstants | None = None):
    """Returns (keypoints [K, 3] float32 (x, y, score; score <= 0 = invalid),
    descriptors [K, 8] uint32)."""
    h, w = gray.shape
    dev = gray.device
    score = _nms3(fast_score(gray, threshold))
    # Exclude the border where descriptor patches would leave the image.
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = (ys >= _HALF) & (ys < h - _HALF) & (xs >= _HALF) & (xs < w - _HALF)
    score = torch.where(inb, score, torch.zeros((), dtype=score.dtype, device=dev))

    # jax.lax.top_k: the K largest, ties to the lower index.
    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top, idx = top[:max_keypoints], idx[:max_keypoints]
    ky = torch.div(idx, w, rounding_mode="floor")
    kx = idx - ky * w
    valid = top > 0

    gpad = pad_edge(gray.to(torch.float32), _HALF, _HALF)
    offs = torch.arange(_PATCH, device=dev)
    patch = gpad[(ky[:, None] + offs[None, :])[:, :, None],
                 (kx[:, None] + offs[None, :])[:, None, :]]  # [K, 31, 31]
    # Orientation: intensity centroid over the full patch.  The moments are
    # integers below 2^24, exact in float32 in any order of summation.
    ys2 = offs.to(torch.float32) - _HALF
    m10 = (patch * ys2[None, None, :]).sum(dim=(1, 2))
    m01 = (patch * ys2[None, :, None]).sum(dim=(1, 2))
    angle = torch.atan2(m01, m10)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

    p = (consts or OrbConstants()).pattern(dev)
    kidx = torch.arange(patch.shape[0], device=dev)[:, None]

    def sample(px, py):
        rx = torch.round(ca * px - sa * py).to(torch.int64) + _HALF
        ry = torch.round(sa * px + ca * py).to(torch.int64) + _HALF
        return patch[kidx, ry.clamp(0, _PATCH - 1), rx.clamp(0, _PATCH - 1)]

    v1 = sample(p[:, 0], p[:, 1])
    v2 = sample(p[:, 2], p[:, 3])
    bits = (v1 < v2).to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, device=dev)
    desc = (bits << shifts).sum(dim=-1).to(torch.uint32)
    kps = torch.stack([kx.to(torch.float32), ky.to(torch.float32),
                       torch.where(valid, top.to(torch.float32),
                                   torch.zeros((), device=dev))], dim=-1)
    return kps, desc


def resize_weights(input_size: int, output_size: int) -> np.ndarray:
    """[input_size, output_size] float32 weights of jax.image.resize's
    'linear' method with antialiasing (a copy of jax/_src/image/scale.py
    compute_weight_mat with the triangle kernel, in the same float32
    steps; scale = output / input, no translation)."""
    f32 = np.float32
    inv_scale = 1.0 / (output_size / input_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(output_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x))
    total = np.zeros((1, output_size), f32)
    for row in weights:  # XLA's reduce over the input axis, in order
        total += row
    eps = f32(1000.0 * float(np.finfo(np.float32).eps))
    weights = np.where(np.abs(total) > eps, weights / np.where(total != 0, total, f32(1)),
                       f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.where(inside[None, :], weights, f32(0)).astype(f32)


def resize_linear(gray: torch.Tensor, out_hw: tuple[int, int],
                  consts: OrbConstants | None = None) -> torch.Tensor:
    """gray uint8 [H, W] -> uint8 [h, w]: jax.image.resize(..., 'linear')
    (antialiased), rounded half to even and clipped to 0..255."""
    h, w = gray.shape
    lh, lw = out_hw
    wy, wx = (consts or OrbConstants()).resize(gray.device, h, w, lh, lw)
    out = wy.T @ (gray.to(torch.float32) @ wx)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def level_budgets(max_keypoints: int, levels: int, scale: float) -> np.ndarray:
    """Keypoints a level: the budget split in proportion to level area
    (OpenCV's ORB_Impl::buildScalePyramid distribution), level 0 taking the
    remainder so the total is exact."""
    areas = np.array([(1.0 / scale) ** (2 * i) for i in range(levels)])
    ks = np.maximum((areas / areas.sum() * max_keypoints).astype(int), 1)
    ks[0] += max_keypoints - int(ks.sum())
    return ks


def level_shape(h: int, w: int, level: int, scale: float) -> tuple[int, int]:
    factor = scale ** level
    return max(int(round(h / factor)), _PATCH + 2), max(int(round(w / factor)), _PATCH + 2)


def detect_orb_pyramid(gray: torch.Tensor, max_keypoints: int = 5000, threshold: int = 20,
                       levels: int = 3, scale: float = 1.4142135,
                       consts: OrbConstants | None = None):
    """Multi-scale ORB: FAST + rBRIEF per pyramid level, keypoints mapped to
    level-0 coordinates (cv::cuda::ORB's scale coverage, features.cpp:48-66).
    Returns (keypoints [K, 4] float32 (x, y, score, level), descriptors
    [K, 8] uint32)."""
    h, w = gray.shape
    consts = consts or OrbConstants()
    kps_all, desc_all = [], []
    for lvl, k in enumerate(level_budgets(max_keypoints, levels, scale)):
        gl = gray if lvl == 0 else resize_linear(gray, level_shape(h, w, lvl, scale), consts)
        kps, desc = detect_orb(gl, int(k), threshold, consts)
        sx = w / gl.shape[1]
        sy = h / gl.shape[0]
        kps = torch.cat([kps[:, :1] * sx, kps[:, 1:2] * sy, kps[:, 2:3],
                         torch.full((kps.shape[0], 1), float(lvl), device=gray.device)], dim=-1)
        kps_all.append(kps)
        desc_all.append(desc)
    return torch.cat(kps_all, dim=0), torch.cat(desc_all, dim=0)
