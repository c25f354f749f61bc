"""Synthetic stereo frames from a seed: the benchmark's own copy of the
port's synthetic source (``sources/synthetic.py``), kept here so that the
frames a cell measures never change with the program.

A textured scene of a ground plane and a fronto-parallel wall slab that
approaches the camera, with an exact disparity map; the right view is the
left texture shifted by the disparity, and the texture pans 2 px a frame,
so optical flow and the temporal vote have real signal.  Frames are BGR
uint8 [H, W, 3] with three equal channels, as the source yields them.

Differences from the source: the seed goes through numpy's SeedSequence, so
any whole number is a seed (the source's RandomState takes 32 bits); the
pan per frame is a parameter; and a cycle of frames is rendered in one
batch of float32 torch operations on the run's device (the source renders
one frame at a time in float64 numpy, which takes seconds a cycle).

Several streams of one run (a multi-stream traffic mix) each show a scene
of their own: stream j's texture draws from ``SeedSequence(seed mod 2**64,
spawn_key=(j,))``, the j-th child that ``SeedSequence.spawn`` gives, for
j >= 1, and stream 0's from the seed's own sequence, the single-stream
scene.  The geometry (ground, wall, pan) is the traffic's and the same for
every stream.
"""

from __future__ import annotations

import numpy as np
import torch


def rng_for(seed: int, stream: int = 0) -> np.random.RandomState:
    """A RandomState seeded from any whole number (negative ones too), for
    stream `stream` of a run (0: the seed's own sequence; j >= 1: its j-th
    spawned child)."""
    spawn_key = (stream,) if stream else ()
    return np.random.RandomState(np.random.MT19937(
        np.random.SeedSequence(seed % (1 << 64), spawn_key=spawn_key)))


def _texture(h, w, rng):
    """Multi-octave blocky texture (scales 16/7/3 are not commensurate, so
    no period ties the SGM uniqueness test)."""
    t = np.zeros((h, w), np.float32)
    for scale, amp in ((16, 55.0), (7, 45.0), (3, 25.0)):
        base = rng.randn(h // scale + 2, w // scale + 2).astype(np.float32)
        t += amp * np.kron(base, np.ones((scale, scale)))[:h, :w]
    t += rng.randn(h, w).astype(np.float32) * 8.0
    lo, hi = np.percentile(t, [1, 99])
    return np.clip((t - lo) / max(hi - lo, 1e-6) * 195 + 30, 0, 255)


class SyntheticScene:
    """One seeded scene (of stream `stream` of the run); ``cycle(n)`` renders
    its frame indices 0..n-1."""

    def __init__(self, image_size: tuple[int, int], seed: int, fx: float = 100.0,
                 baseline: float = 0.5, max_disparity: float = 40.0, pan_px: int = 2,
                 stream: int = 0):
        self.image_size = tuple(image_size)
        self.fx = fx
        self.baseline = baseline
        self.max_disparity = max_disparity
        self.pan_px = pan_px
        h, w = self.image_size
        self._tex = _texture(h, w + int(max_disparity) + 8, rng_for(seed, stream))
        q = np.eye(4, dtype=np.float32)
        q[0, 3] = -w / 2
        q[1, 3] = -h / 2
        q[2, 2] = 0.0
        q[2, 3] = fx
        q[3, 2] = 1.0 / baseline
        q[3, 3] = 0.0
        self.q = q

    def disparity(self, frame_idx: int) -> np.ndarray:
        """Float disparity [H, W] of frame index frame_idx."""
        h, w = self.image_size
        ys = np.arange(h)[:, None].astype(np.float32)
        horizon = 0.35 * h
        ground = np.clip((ys - horizon) / (h - horizon), 0, None) * self.max_disparity * 0.8
        disp = np.broadcast_to(ground, (h, w)).copy()
        z0 = max(30.0 - 0.8 * frame_idx, 5.0)
        wall_d = self.fx * self.baseline / z0
        x0, x1 = int(0.55 * w), int(0.85 * w)
        y0 = int(horizon - 0.2 * h)
        y1 = int(horizon + (wall_d / self.max_disparity) * (h - horizon) / 0.8 * 0.8)
        y1 = min(max(y1, y0 + 4), h)
        disp[y0:y1, x0:x1] = np.maximum(disp[y0:y1, x0:x1], wall_d)
        return np.minimum(disp, self.max_disparity)

    def cycle(self, length: int, device="cpu") -> list[tuple[np.ndarray, np.ndarray]]:
        """Frame indices 0..length-1 as host (left, right) BGR uint8 [H, W, 3]
        pairs, rendered on `device`: the frames a stream cycles through."""
        h, w = self.image_size
        tex = torch.from_numpy(self._tex.astype(np.float32)).to(device)
        wt = tex.shape[1]
        idx = torch.arange(length, device=device)
        disp = torch.from_numpy(np.stack([self.disparity(i) for i in range(length)])
                                .astype(np.float32)).to(device)  # [L, H, W]
        shift = (self.pan_px * idx)[:, None, None]
        rows = torch.arange(h, device=device)[None, :, None]
        cols = torch.arange(w, device=device)[None, None, :]
        # The texture rolled left by the frame's pan: column c of frame i is
        # texture column (c + shift_i) mod its width.
        left = tex[rows, (cols + shift) % wt]
        # left[x] == right[x - d]: right[x] = tex[x + d(x)] to first order.
        xs = cols.to(torch.float32) + disp
        x0 = torch.floor(xs).to(torch.int64).clamp(0, wt - 2)
        f = xs - x0.to(torch.float32)
        right = (tex[rows, (x0 + shift) % wt] * (1 - f)
                 + tex[rows, (x0 + 1 + shift) % wt] * f)

        def to_bgr(g):
            g = g.clamp(0, 255).to(torch.uint8)[..., None].expand(*g.shape, 3)
            return g.contiguous().cpu().numpy()

        lefts, rights = to_bgr(left), to_bgr(right)
        return [(lefts[i], rights[i]) for i in range(length)]
