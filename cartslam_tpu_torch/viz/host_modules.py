"""Host-side visualization modules (reference: §2.4 of the module zoo; the
port's copy of cartslam_tpu/viz/host_modules.py, numpy only).

Each consumes fetched numpy outputs and renders BGR uint8 images for the
image sink (window viewer / PNG sampler / video recorder).  Color contracts
follow the reference: plane overlay blue/green/red = horizontal/vertical/
unknown at 50% blend (include/modules/planeseg.hpp:43-71), invalid
disparity painted red (disparity.cu:139-147).
"""

from __future__ import annotations

import numpy as np

from ..runtime.module import Dependency, HostModule
from ..utils.colors import compute_color, index_color

DISPARITY_INVALID = -32768

PLANE_COLORS_BGR = np.array(
    [
        [255, 0, 0],  # HORIZONTAL -> blue
        [0, 255, 0],  # VERTICAL   -> green
        [0, 0, 255],  # UNKNOWN    -> red
    ],
    np.uint8,
)


def _left_bgr(frame):
    img = frame["left"]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


class DisparityVisualization(HostModule):
    name = "ImageDisparityVisualization"

    def requires(self):
        return [Dependency("disparity")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        disp = fetched["disparity"].astype(np.int32)
        vis = np.clip(disp / 16.0, 0, 255).astype(np.uint8)
        vis = np.repeat(vis[..., None], 3, axis=-1)
        vis[disp == DISPARITY_INVALID] = (0, 0, 255)
        return np.concatenate([_left_bgr(frame), vis], axis=0)


class DerivativeVisualization(HostModule):
    name = "ImageDisparityDerivativeVisualization"

    def requires(self):
        return [Dependency("disparity_derivative")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        deriv = fetched["disparity_derivative"].astype(np.float32)
        dx, dy = deriv[..., 0], deriv[..., 1]
        valid = (deriv[..., 0] != DISPARITY_INVALID) & (
            deriv[..., 1] != DISPARITY_INVALID
        )
        maxrad = np.sqrt(max((dx[valid] ** 2 + dy[valid] ** 2).max(), 1.0)) if valid.any() else 1.0
        img = compute_color(dx / maxrad, dy / maxrad)
        img[~valid] = (0, 255, 255)
        return np.concatenate([_left_bgr(frame), img], axis=0)


class DepthVisualization(HostModule):
    name = "DepthVisualization"

    def requires(self):
        return [Dependency("depth")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        z = fetched["depth"][..., 2]
        img = np.clip(z * (255.0 / 10.0), 0, 255).astype(np.uint8)
        return np.repeat(img[..., None], 3, axis=-1)


def _draw_line(img, p0, p1, color):
    """Tiny AA-free line rasterizer (numpy; keeps the viz cv2-free)."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1))
    xs = np.linspace(p0[0], p1[0], n + 1).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n + 1).round().astype(int)
    m = (xs >= 0) & (ys >= 0) & (xs < img.shape[1]) & (ys < img.shape[0])
    img[ys[m], xs[m]] = color


def _draw_arrow(img, p0, p1, color):
    _draw_line(img, p0, p1, color)
    # Two short head strokes at ~30 degrees.
    v = np.array([p0[0] - p1[0], p0[1] - p1[1]], np.float32)
    n = np.linalg.norm(v)
    if n < 1:
        return
    v = v / n * min(6.0, n * 0.3)
    for ang in (0.5, -0.5):
        c, s = np.cos(ang), np.sin(ang)
        tip = (p1[0] + v[0] * c - v[1] * s, p1[1] + v[0] * s + v[1] * c)
        _draw_line(img, p1, tip, color)


class OpticalFlowVisualization(HostModule):
    """Flow panel stack + probe arrows (src/modules/optflow.cpp:134-173).

    Layout matches the reference: current image / previous image /
    false-color flow, with green arrows from each probe point (drawn in
    the previous-image panel) to point - flow (current panel coords).
    """

    name = "ImageOpticalFlowVisualization"

    def __init__(self, points: int = 10):
        self.points = points
        self._probes = None
        self._prev_left: np.ndarray | None = None

    def requires(self):
        return [Dependency("optflow")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        left = _left_bgr(frame)
        prev = self._prev_left
        self._prev_left = left.copy()
        if frame_id <= 1 or prev is None:
            return None
        flow = fetched["optflow"].astype(np.float32) / 32.0
        fx, fy = flow[..., 0], flow[..., 1]
        h, w = fx.shape
        if self._probes is None:
            rng = np.random.RandomState(271)  # fixed probes, like the module
            self._probes = np.stack(
                [rng.randint(0, w, self.points), rng.randint(0, h, self.points)],
                axis=-1,
            )
        maxrad = np.sqrt(max((fx**2 + fy**2).max(), 1.0))
        flow_img = compute_color(fx / maxrad, fy / maxrad)
        out = np.concatenate([left, prev, flow_img], axis=0).copy()
        for px, py in self._probes:
            start = (int(px), int(py) + h)  # probe in the previous panel
            end = (int(px - fx[py, px]), int(py - fy[py, px]))
            _draw_arrow(out, start, end, np.array([0, 255, 0], np.uint8))
        return out


class SuperPixelVisualization(HostModule):
    name = "SuperPixelVisualization"

    def requires(self):
        return [Dependency("superpixels")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        labels = fetched["superpixels"]
        img = _left_bgr(frame).copy()
        b = np.zeros(labels.shape, bool)
        b[:, 1:] |= labels[:, 1:] != labels[:, :-1]
        b[:, :-1] |= labels[:, :-1] != labels[:, 1:]
        b[1:, :] |= labels[1:, :] != labels[:-1, :]
        b[:-1, :] |= labels[:-1, :] != labels[1:, :]
        img[b] = (0, 0, 255)
        return img


class PlaneSegmentationVisualization(HostModule):
    name = "PlaneSegmentationVisualization"

    def __init__(self, show_histogram: bool = True, show_unsmoothed: bool = True):
        self.show_histogram = show_histogram
        self.show_unsmoothed = show_unsmoothed

    def requires(self):
        deps = [Dependency("planes"), Dependency("planes_unsmoothed", optional=True)]
        return deps

    def _overlay(self, image, planes):
        colors = PLANE_COLORS_BGR[planes]
        return (image // 2 + colors // 2).astype(np.uint8)

    def render(self, ctx, frame_id, frame, fetched, globals_):
        image = _left_bgr(frame)
        out = {}
        main = self._overlay(image, fetched["planes"])
        if self.show_unsmoothed and "planes_unsmoothed" in fetched:
            un = self._overlay(image, fetched["planes_unsmoothed"])
            main = np.concatenate([main, un], axis=0)
        out["Plane Segmentation"] = main

        # Prefer the per-frame accumulating histogram (the reference's vis
        # plots the live running total every frame, planeseg_vis.cu:111-211);
        # the interval snapshot is the fallback.
        hist_key = (
            "disp_derivative_histogram_live"
            if "disp_derivative_histogram_live" in globals_
            else "disp_derivative_histogram"
        )
        if self.show_histogram and hist_key in globals_:
            out["Plane Segmentation Histogram"] = self._hist_image(
                globals_, hist_key
            )
        return out

    def _hist_image(self, globals_, hist_key="disp_derivative_histogram"):
        hist = np.asarray(globals_[hist_key], np.float64)
        hist_w, hist_h = 1024, 800
        bin_w = hist_w // 256
        img = np.zeros((hist_h, hist_w, 3), np.uint8)
        m = hist.max() if hist.max() > 0 else 1
        norm = (hist / m * (hist_h - 20)).astype(np.int32)

        params = globals_.get("plane_parameters")
        for i in range(256):
            color = (255, 0, 0)
            if params is not None:
                if params.horizontal_range[0] + 128 <= i < params.horizontal_range[1] + 128:
                    color = tuple(int(c) for c in PLANE_COLORS_BGR[0])
                elif params.vertical_range[0] + 128 <= i < params.vertical_range[1] + 128:
                    color = tuple(int(c) for c in PLANE_COLORS_BGR[1])
            h = norm[i]
            img[hist_h - 1 - h : hist_h, i * bin_w : (i + 1) * bin_w] = color
        return img


class BEVVisualization(HostModule):
    """Top-down occupancy of VERTICAL-plane pixels (planeseg_vis.cu:58-107)."""

    name = "PlaneSegmentationBEVVisualization"

    def requires(self):
        return [Dependency("planes"), Dependency("depth")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        planes = fetched["planes"]
        depth = fetched["depth"]
        rows, cols, max_depth = 300, 600, 20.0
        out = np.full((rows, cols, 3), 255, np.uint8)

        mask = planes == 1  # VERTICAL
        x, y, z = depth[..., 0][mask], depth[..., 1][mask], depth[..., 2][mask]
        ok = (z <= max_depth) & (z >= 0.0) & (x >= -10.0) & (x <= 10.0)
        x, y, z = x[ok], y[ok], z[ok]
        max_width = (max_depth / rows) * (cols / 2)
        r = rows - np.round((z / max_depth) * rows).astype(np.int32) - 1
        c = np.round((x / max_width) * cols).astype(np.int32) + cols // 2
        keep = (r >= 0) & (r < rows) & (c >= 0) & (c < cols)
        r, c, y, z = r[keep], c[keep], y[keep], z[keep]
        ch = np.where(y > -0.5, 0, 1)
        dec = np.ceil(1 * (z / 3 + 1)).astype(np.int32)
        # Vectorized form of the reference's sequential per-pixel decay
        # (planeseg_vis.cu:58-107): per-step saturation at 0 is equivalent
        # to saturating the summed decrement, and the blue channel ends at
        # the final value of whichever channel the LAST point hitting that
        # cell voted for (numpy fancy assignment keeps last-write-wins).
        if r.size:
            cell = r.astype(np.int64) * cols + c
            tot = np.bincount(cell * 2 + ch, weights=dec, minlength=rows * cols * 2)
            vals = np.maximum(255.0 - tot, 0.0).astype(np.uint8).reshape(rows, cols, 2)
            out[..., :2] = vals
            last = np.full(rows * cols, -1, np.int64)
            last[cell] = np.arange(cell.size)
            touched = np.flatnonzero(last >= 0)
            out.reshape(-1, 3)[touched, 2] = vals.reshape(-1, 2)[
                touched, ch[last[touched]]
            ]
        return np.repeat(np.repeat(out, 2, axis=0), 2, axis=1)


class FeatureVisualization(HostModule):
    name = "ImageFeatureVisualization"

    def requires(self):
        return [Dependency("features")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        img = _left_bgr(frame).copy()
        feats = fetched["features"]  # [2, K, 4] (x, y, score, level)
        if feats.ndim == 3:
            feats = feats[0]  # the left image's keypoints
        for x, y, v in feats[:, :3]:
            if v <= 0:
                continue
            x, y = int(x), int(y)
            img[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = (0, 255, 0)
        return img


class PlaneFitVisualization(HostModule):
    name = "SuperPixelPlaneFitVisualization"

    def requires(self):
        return [Dependency("superpixels")]

    def render(self, ctx, frame_id, frame, fetched, globals_):
        # planes_eq is per-run data (fetched); globals_ keeps the latest
        # copy as a fallback.
        fit = fetched.get("planes_eq") or globals_.get("planes_eq")
        if fit is None:
            return None
        labels = fetched["superpixels"]
        assignments = np.asarray(fit["assignments"])
        plane_count = max(len(fit["planes"]), 1)
        assigned = assignments[labels]
        colors = index_color(assigned.astype(np.float32) / plane_count)
        colors[assigned == 0] = 0
        img = _left_bgr(frame)
        return (img // 2 + colors // 2).astype(np.uint8)
