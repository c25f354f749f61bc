"""Synthetic stereo source with known ground truth (test fake backend).

Renders a textured scene of a ground plane + fronto-parallel walls with an
exact disparity map, then shifts to synthesize the right view.  Camera
translates forward each frame, so optical flow and temporal smoothing have
real signal.  This is the "fake backend" the reference lacks (SURVEY §4).
"""

from __future__ import annotations

import numpy as np

from .base import DataSource


def _texture(h, w, rng):
    """Multi-octave blocky texture.

    Non-commensurate scales (16/7/3) avoid the periodic-match ambiguity a
    single block size creates for stereo (a d±period alias ties the SGM
    uniqueness test and invalidates whole regions).
    """
    t = np.zeros((h, w), np.float32)
    for scale, amp in ((16, 55.0), (7, 45.0), (3, 25.0)):
        base = rng.randn(h // scale + 2, w // scale + 2).astype(np.float32)
        t += amp * np.kron(base, np.ones((scale, scale)))[:h, :w]
    t += rng.randn(h, w).astype(np.float32) * 8.0
    lo, hi = np.percentile(t, [1, 99])
    return np.clip((t - lo) / max(hi - lo, 1e-6) * 195 + 30, 0, 255)


class SyntheticDataSource(DataSource):
    def __init__(
        self,
        image_size: tuple[int, int] = (96, 192),
        num_frames: int = 20,
        seed: int = 0,
        fx: float = 100.0,
        baseline: float = 0.5,
        max_disparity: float = 40.0,
    ):
        super().__init__(image_size)
        self.num_frames = num_frames
        self.fx = fx
        self.baseline = baseline
        self.max_disparity = max_disparity
        self._frame = 0
        self._rng = np.random.RandomState(seed)
        h, w = image_size
        self._tex = _texture(h, w + int(max_disparity) + 8, self._rng)

        q = np.eye(4, dtype=np.float32)
        q[0, 3] = -w / 2
        q[1, 3] = -h / 2
        q[2, 2] = 0.0
        q[2, 3] = fx
        q[3, 2] = 1.0 / baseline  # sign chosen so Z > 0 for d > 0
        q[3, 3] = 0.0
        self.intrinsics.q = q

    def ground_truth_disparity(self, frame_idx: int) -> np.ndarray:
        """Float disparity [H, W] for the given frame index (0-based)."""
        h, w = self.image_size
        ys = np.arange(h)[:, None].astype(np.float32)
        horizon = 0.35 * h
        # Ground plane: disparity grows linearly below the horizon.
        ground = np.clip(
            (ys - horizon) / (h - horizon), 0, None
        ) * self.max_disparity * 0.8
        disp = np.broadcast_to(ground, (h, w)).copy()
        # A wall slab that approaches the camera over time.
        z0 = 30.0 - 0.8 * frame_idx
        z0 = max(z0, 5.0)
        wall_d = self.fx * self.baseline / z0
        x0, x1 = int(0.55 * w), int(0.85 * w)
        y0 = int(horizon - 0.2 * h)
        y1 = int(horizon + (wall_d / self.max_disparity) * (h - horizon) / 0.8 * 0.8)
        y1 = min(max(y1, y0 + 4), h)
        disp[y0:y1, x0:x1] = np.maximum(disp[y0:y1, x0:x1], wall_d)
        return np.minimum(disp, self.max_disparity)

    # Ground-truth accessors for the quality metrics (utils/quality.py).

    GT_GROUND, GT_WALL, GT_SKY = 0, 1, 2

    def ground_truth_regions(self, frame_idx: int) -> np.ndarray:
        """uint8 [H, W] region map: 0=ground plane, 1=wall slab, 2=sky."""
        h, w = self.image_size
        disp = self.ground_truth_disparity(frame_idx)
        horizon = int(0.35 * h)
        regions = np.full((h, w), self.GT_SKY, np.uint8)
        regions[horizon:, :] = self.GT_GROUND
        ys = np.arange(h)[:, None].astype(np.float32)
        ground = np.clip(
            (ys - 0.35 * h) / (h - 0.35 * h), 0, None
        ) * self.max_disparity * 0.8
        wall = disp > np.broadcast_to(ground, (h, w)) + 1e-3
        regions[wall] = self.GT_WALL
        return regions

    def ground_truth_flow(self, frame_idx: int) -> np.ndarray:
        """float32 [H, W, 2] flow current->previous (prev = cur - flow).

        The texture pans left 2 px/frame (see _render's roll), so content at
        x was at x + 2 in the previous frame: flow_x = -2 for frame_idx >= 1.
        """
        h, w = self.image_size
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 0] = -2.0 if frame_idx >= 1 else 0.0
        return flow

    def _render(self, frame_idx: int):
        h, w = self.image_size
        disp = self.ground_truth_disparity(frame_idx)
        shift = int(2 * frame_idx)  # camera pans right slowly -> optical flow
        tex = np.roll(self._tex, -shift, axis=1)
        left = tex[:, : w]
        # Stereo convention: left[x] == right[x - d]; for a smooth disparity
        # field, right[x] = tex[x + d(x)] to first order.
        xs = np.arange(w)[None, :] + disp
        x0 = np.clip(np.floor(xs).astype(int), 0, tex.shape[1] - 2)
        f = xs - x0
        rows = np.arange(h)[:, None]
        right = tex[rows, x0] * (1 - f) + tex[rows, x0 + 1] * f
        to_bgr = lambda g: np.repeat(
            np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, axis=-1
        )
        return to_bgr(left), to_bgr(right), disp

    def is_next_ready(self) -> bool:
        return self._frame < self.num_frames

    def is_finished(self) -> bool:
        return not self.is_next_ready()

    def get_next(self):
        if self.is_finished():
            return None
        left, right, _ = self._render(self._frame)
        self._frame += 1
        return {"left": left, "right": right}

    def skip(self, n: int) -> None:
        """Seek past the first n frames (checkpoint resume)."""
        self._frame = n
