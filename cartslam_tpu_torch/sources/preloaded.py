"""RAM-staged frame playback: decode-free DataSource.

Serves frames already decoded into host memory — the configuration for
measuring (and deploying) the System host loop without file-IO/decode in
the frame path, e.g. when an upstream stage (capture card, network
receiver) already delivers decoded images.  `wrap` stages another
source's whole sequence up front.

The reference has no direct analogue (its sources always decode from
disk or the ZED SDK, src/sources/kitti.cpp:54-101); this is the TPU-host
equivalent of keeping the input pipeline off the critical path.
"""

from __future__ import annotations

from .base import CameraIntrinsics, DataSource


class PreloadedSource(DataSource):
    """Plays back a list of pre-decoded frame dicts, optionally looped.

    Args:
        frames: list of dicts with at least 'left'/'right' uint8 arrays
            (source extras like 'zed_disparity' pass through).
        intrinsics: CameraIntrinsics to expose (identity Q otherwise).
        loop: how many times to replay the list (total = len(frames)*loop).
    """

    def __init__(
        self,
        frames: list[dict],
        intrinsics: CameraIntrinsics | None = None,
        loop: int = 1,
    ):
        if not frames:
            raise ValueError("PreloadedSource needs at least one frame")
        super().__init__(image_size=tuple(frames[0]["left"].shape[:2]))
        self.frames = frames
        self.total = len(frames) * loop
        self._i = 0
        if intrinsics is not None:
            self.intrinsics = intrinsics

    @classmethod
    def wrap(cls, source: DataSource, max_frames: int | None = None,
             loop: int = 1) -> "PreloadedSource":
        """Stage `source`'s sequence (or its first `max_frames`) in RAM."""
        frames = []
        while not source.is_finished():
            if max_frames is not None and len(frames) >= max_frames:
                break
            f = source.get_next()
            if f is None:
                break
            frames.append(f)
        return cls(frames, intrinsics=source.get_camera_intrinsics(),
                   loop=loop)

    def is_next_ready(self) -> bool:
        return self._i < self.total

    def is_finished(self) -> bool:
        return self._i >= self.total

    def get_next(self) -> dict | None:
        if self.is_finished():
            return None
        frame = self.frames[self._i % len(self.frames)]
        self._i += 1
        return frame

    def skip(self, n: int) -> None:
        """Seek past the first n frames (checkpoint resume)."""
        self._i = min(int(n), self.total)


__all__ = ["PreloadedSource"]
