"""ZED-format stereo source (the port's copy of cartslam_tpu/sources/zed.py).

The ZED SDK / SVO playback (reference: src/sources/zed.cpp) needs the
camera vendor's SDK; this source keeps the *module contract* (a stereo pair
plus an optional SDK-style float disparity measure, 'zed_disparity',
consumed by the zed_disparity module, src/modules/disparity/disparity.cu:
18-45) over two interchangeable container formats:

  * a directory of frames:  left/NNNNNN.png, right/NNNNNN.png,
    optional disparity/NNNNNN.npy (float32), and intrinsics.json
    {"fx":, "fy":, "cx":, "cy":, "baseline":, "cx_right": optional}
  * a single .npz archive with arrays left [N,H,W,3], right [N,H,W,3],
    optional disparity [N,H,W] float32, and scalars fx, cx, cy, baseline.

The System converts the frames to gray at the source boundary when the
grayscale switch is on (sources/base.to_grayscale); the measure passes
through.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np

from .base import DataSource, DecodePrefetcher, resize_bgr
from ..utils.imageio import imread_bgr


def _build_q(fx, cx, cy, baseline, cx_right=None, sw=1.0, sh=1.0):
    q = np.eye(4, dtype=np.float32)
    q[0, 3] = -cx * sw
    q[1, 3] = -cy * sh
    q[2, 2] = 0.0
    q[2, 3] = fx * sw
    q[3, 2] = -1.0 / baseline
    q[3, 3] = ((cx - (cx_right if cx_right is not None else cx)) * sw) / baseline
    return q


class _NpzFrames:
    """Frame i of an [N, ...] array stored in an .npz archive, read from its
    zip member alone: one frame in host memory at a time.  (An NpzFile
    reads a member's whole array at every access, so indexing it costs the
    whole recording a frame.)  Sequential reads need no seek; a seek
    within a compressed member decompresses up to its target."""

    def __init__(self, archive: zipfile.ZipFile, key: str):
        self._f = archive.open(key + ".npy")
        version = np.lib.format.read_magic(self._f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(self._f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(self._f)
        else:
            raise ValueError(f"{key}: .npy format {version} is not supported")
        if fortran or dtype.hasobject or len(shape) < 1:
            raise ValueError(f"{key}: expected a C-ordered [N, ...] array, got {shape} {dtype}")
        self.shape, self.dtype = shape, dtype
        self._start = self._f.tell()
        self._bytes = int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize

    def __len__(self) -> int:
        return self.shape[0]

    def frame(self, i: int) -> np.ndarray:
        pos = self._start + i * self._bytes
        if self._f.tell() != pos:
            self._f.seek(pos)
        out = np.empty(self.shape[1:], self.dtype)
        if self._f.readinto(memoryview(out).cast("B")) != self._bytes:
            raise EOFError(f"frame {i} of {self.shape[0]} is truncated")
        return out


class ZEDDataSource(DataSource):
    def __init__(
        self,
        path: str,
        include_disparity: bool = False,
        image_size: tuple[int, int] | None = None,
        real_time_mode: bool = False,
        fps: float = 15.0,
        decode_workers: int = 6,
    ):
        """real_time_mode paces playback at the recording's fps — the
        CARTSLAM_ZED_REALTIME_MODE option (src/sources/zed.cpp:16-18), as a
        runtime flag instead of a compile-time define."""
        super().__init__(image_size)
        path = os.path.expanduser(path)
        self.include_disparity = include_disparity
        self.real_time_mode = real_time_mode
        self.fps = fps
        # Dir-format 720p PNGs decode at ~40 ms each; pooled read-ahead
        # keeps the source above the device step rate (see
        # base.DecodePrefetcher).  The npz path reads one frame a side
        # from the archive's members (_NpzFrames) and needs none.
        self.decode_workers = decode_workers
        self._t0: float | None = None
        self._frame = 0

        if path.endswith(".npz"):
            self._npz = np.load(path)
            archive = zipfile.ZipFile(path)
            keys = ("left", "right") + (("disparity",) if "disparity" in self._npz else ())
            self._frames = {k: _NpzFrames(archive, k) for k in keys}
            self._num = len(self._frames["left"])
            native = self._frames["left"].shape[1:3]
            self._dir = None
        else:
            self._npz = None
            self._dir = path
            lefts = sorted(os.listdir(os.path.join(path, "left")))
            self._num = len(lefts)
            first = imread_bgr(os.path.join(path, "left", lefts[0]))
            native = first.shape[:2]

        if self.image_size is None:
            self.image_size = tuple(native)
        sh = self.image_size[0] / native[0]
        sw = self.image_size[1] / native[1]

        if self._npz is not None:
            meta = {k: float(self._npz[k]) for k in ("fx", "cx", "cy", "baseline")}
            cx_right = float(self._npz["cx_right"]) if "cx_right" in self._npz else None
        else:
            with open(os.path.join(path, "intrinsics.json")) as f:
                meta = json.load(f)
            cx_right = meta.get("cx_right")
        self.intrinsics.q = _build_q(
            meta["fx"], meta["cx"], meta["cy"], meta["baseline"], cx_right, sw, sh
        )

    def is_next_ready(self) -> bool:
        if self._frame >= self._num:
            return False
        if self.real_time_mode:
            import time

            if self._t0 is None:
                self._t0 = time.monotonic()
            due = self._t0 + self._frame / self.fps
            return time.monotonic() >= due
        return True

    def is_finished(self) -> bool:
        return self._frame >= self._num

    def get_next(self):
        if self.is_finished():
            return None
        if self.real_time_mode:
            import time

            while not self.is_next_ready():
                time.sleep(0.001)
        i = self._frame
        self._frame += 1
        if self._npz is not None:
            left = self._frames["left"].frame(i)
            right = self._frames["right"].frame(i)
            disp = (
                self._frames["disparity"].frame(i).astype(np.float32, copy=False)
                if self.include_disparity and "disparity" in self._frames
                else None
            )
        else:
            for ahead in range(self.decode_workers // 2 + 1):
                self._submit_dir(i + ahead)
            left, right = self._prefetcher().take(i)
            dpath = os.path.join(self._dir, "disparity", f"{i:06d}.npy")
            disp = (
                np.load(dpath).astype(np.float32)
                if self.include_disparity and os.path.exists(dpath)
                else None
            )
        out = {
            "left": resize_bgr(left, self.image_size),
            "right": resize_bgr(right, self.image_size),
        }
        if self.include_disparity:
            if disp is None:
                disp = np.full(self.image_size, np.inf, np.float32)
            out["zed_disparity"] = disp
        return out

    def _prefetcher(self) -> DecodePrefetcher:
        if not hasattr(self, "_decode"):
            self._decode = DecodePrefetcher(
                self.decode_workers, name="zed-decode"
            )
        return self._decode

    def _submit_dir(self, i: int) -> None:
        pf = self._prefetcher()
        if i >= self._num or pf.has(i):
            return
        paths = [
            os.path.join(self._dir, side, f"{i:06d}.png")
            for side in ("left", "right")
        ]
        pf.submit(i, [lambda p=p: imread_bgr(p) for p in paths])

    def skip(self, n: int) -> None:
        """Seek past the first n frames (checkpoint resume)."""
        self._frame = n
        if hasattr(self, "_decode"):
            self._decode.clear()
