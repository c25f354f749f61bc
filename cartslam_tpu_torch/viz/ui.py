"""Image sinks: viewer thread, PNG sampler, video recorder (the port's copy
of cartslam_tpu/viz/ui.py; cv2 is imported only by the video recorder and
the viewer).

Mirrors the reference UI subsystem (src/utils/ui.cpp): a singleton-style
viewer polling registered providers at ~40 FPS with drop-late-frame
semantics (`setImageIfLater`, ui.cpp:73-91), optional every-30th-frame PNG
sampling and AVI recording (ui.cpp:74-80,142-156).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np


class ImageStore:
    """Latest-image store with drop-late-frame semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._images: dict[str, tuple[int, np.ndarray]] = {}

    def set_image_if_later(self, window: str, image: np.ndarray, frame_id: int):
        with self._lock:
            cur = self._images.get(window)
            if cur is None or frame_id > cur[0]:
                self._images[window] = (frame_id, image)

    def snapshot(self) -> dict[str, tuple[int, np.ndarray]]:
        with self._lock:
            return dict(self._images)


class SampleSink(ImageStore):
    """Writes every `interval`-th frame per window to samples/ as PNG (the
    frames with frame_id % interval == 0, as the JAX sink does).  With
    `write_last_on_close`, close() also writes each window's latest frame
    if it was not written yet, so a run shorter than the interval leaves a
    sample; off by default."""

    def __init__(self, directory: str = "samples", interval: int = 30,
                 write_last_on_close: bool = False):
        super().__init__()
        self.directory = directory
        self.interval = interval
        self.write_last_on_close = write_last_on_close
        self._written: dict[str, int] = {}
        os.makedirs(directory, exist_ok=True)

    def _write(self, window, image, frame_id):
        from ..utils.imageio import imwrite_bgr

        safe = window.replace(" ", "_").replace("/", "_")
        imwrite_bgr(os.path.join(self.directory, f"{safe}-{frame_id:06d}.png"), image)
        self._written[window] = frame_id

    def set_image_if_later(self, window, image, frame_id):
        super().set_image_if_later(window, image, frame_id)
        if frame_id % self.interval == 0:
            self._write(window, image, frame_id)

    def close(self):
        if not self.write_last_on_close:
            return
        for window, (fid, image) in self.snapshot().items():
            if self._written.get(window) != fid:
                self._write(window, image, fid)


class VideoSink(ImageStore):
    """Records one video per window (requires cv2)."""

    def __init__(self, directory: str = "recordings", fps: float = 10.0):
        super().__init__()
        self.directory = directory
        self.fps = fps
        self._writers = {}
        os.makedirs(directory, exist_ok=True)

    def set_image_if_later(self, window, image, frame_id):
        super().set_image_if_later(window, image, frame_id)
        import cv2

        if window not in self._writers:
            safe = window.replace(" ", "_")
            path = os.path.join(self.directory, f"{safe}.avi")
            fourcc = cv2.VideoWriter_fourcc(*"MJPG")
            self._writers[window] = cv2.VideoWriter(
                path, fourcc, self.fps, (image.shape[1], image.shape[0])
            )
        img = image if image.ndim == 3 else np.repeat(image[..., None], 3, -1)
        self._writers[window].write(img)

    def close(self):
        for w in self._writers.values():
            w.release()
        self._writers.clear()


class WindowViewer(ImageStore):
    """cv2 window poller at ~40 FPS (ui.cpp:93-166)."""

    def __init__(self):
        super().__init__()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        import cv2

        shown: dict[str, int] = {}
        while not self._stop.is_set():
            for window, (fid, img) in self.snapshot().items():
                if shown.get(window) == fid:
                    continue
                cv2.imshow(window, img)
                shown[window] = fid
            cv2.waitKey(25)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class MultiSink:
    def __init__(self, *sinks):
        self.sinks = sinks

    def set_image_if_later(self, window, image, frame_id):
        for s in self.sinks:
            s.set_image_if_later(window, image, frame_id)
