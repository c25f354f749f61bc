"""The host step of the superpixel plane segmentation, in numpy: the running
histogram of the vertical derivative and the histogram-peak provider that
turns it into the classification ranges (the reference's
HistogramPeakPlaneParameterProvider, src/modules/planeseg/planeseg.cu:405-458,
with its persistence peak finder, src/utils/peaks.cpp:12-72).

``HostStep.update(frame_id, histogram)`` is one frame's host update, as the
System runs it when it drains the frame; it returns the new ranges on the
frames that refresh them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Peak:
    born: int
    left: int
    right: int
    died: int = -1

    def persistence(self, data: np.ndarray) -> float:
        return float("inf") if self.died == -1 else float(data[self.born] - data[self.died])


def find_peaks(data: np.ndarray) -> list[Peak]:
    """Peaks by persistence: indices in order of descending value (stable),
    runs grow left and right, and where two runs meet the one born lower
    dies."""
    data = np.asarray(data).reshape(-1)
    n = data.shape[0]
    idx_to_peak = np.full(n, -1, dtype=np.int64)
    peaks: list[Peak] = []
    for idx in np.argsort(-data, kind="stable"):
        idx = int(idx)
        left_done = idx > 0 and idx_to_peak[idx - 1] != -1
        right_done = idx < n - 1 and idx_to_peak[idx + 1] != -1
        il = idx_to_peak[idx - 1] if left_done else -1
        ir = idx_to_peak[idx + 1] if right_done else -1
        if not left_done and not right_done:
            peaks.append(Peak(born=idx, left=idx, right=idx))
            idx_to_peak[idx] = len(peaks) - 1
        elif left_done and not right_done:
            peaks[il].right += 1
            idx_to_peak[idx] = il
        elif not left_done and right_done:
            peaks[ir].left -= 1
            idx_to_peak[idx] = ir
        elif data[peaks[il].born] > data[peaks[ir].born]:
            peaks[ir].died = idx
            peaks[il].right = peaks[ir].right
            idx_to_peak[peaks[il].right] = il
            idx_to_peak[idx] = il
        else:
            peaks[il].died = idx
            peaks[ir].left = peaks[il].left
            idx_to_peak[peaks[ir].left] = ir
            idx_to_peak[idx] = ir
    peaks.sort(key=lambda p: p.persistence(data), reverse=True)
    return peaks


@dataclasses.dataclass
class Params:
    horizontal_range: tuple[int, int] = (0, 0)
    vertical_range: tuple[int, int] = (0, 0)
    horizontal_center: int = 0
    vertical_center: int = 0

    def ranges(self) -> np.ndarray:
        return np.array([list(self.horizontal_range), list(self.vertical_range)], np.int32)


def peak_params(hist: np.ndarray, current: Params) -> Params:
    """The ranges from the two most persistent peaks of a 256-bin
    histogram: the peak nearer bin 128 is the vertical one, the valley
    between them splits the ranges, widths come from the peak-to-valley
    slope.  Where that fails, the current parameters stay."""
    hist = np.asarray(hist).reshape(-1).astype(np.int64)
    peaks = find_peaks(hist)
    if len(peaks) < 2:
        return current
    p0, p1 = peaks[0], peaks[1]
    if abs(p0.born - 128) > abs(p1.born - 128):
        p0, p1 = p1, p0
    min_index = min(p0.born, p1.born)
    for i in range(min_index, max(p0.born, p1.born)):
        if hist[i] < hist[min_index]:
            min_index = i
    v_dist, h_dist = abs(min_index - p0.born), abs(min_index - p1.born)
    if v_dist == 0 or h_dist == 0:
        return current
    v_deriv = (hist[p0.born] - hist[min_index]) // v_dist
    h_deriv = (hist[p1.born] - hist[min_index]) // h_dist
    if v_deriv == 0 or h_deriv == 0:
        return current
    v_width = int(hist[p0.born] // v_deriv)
    h_width = int(hist[p1.born] // h_deriv)
    return Params(
        vertical_range=(p0.born - v_width - 128, min_index - 127),
        horizontal_range=(min_index - 127, p1.born + h_width - 127),
        vertical_center=p0.born - 128,
        horizontal_center=p1.born - 128,
    )


class HostStep:
    """The running histogram and the provider: the first frame's histogram
    is not added to the total; the total restarts after frame ids == 1
    (mod update_interval * reset_interval); the ranges refresh at frame ids
    == 1 (mod update_interval) from the snapshot of that frame."""

    def __init__(self, update_interval: int = 30, reset_interval: int = 10):
        self.update_interval = update_interval
        self.reset_interval = reset_interval
        self.params = Params()
        self.running: np.ndarray | None = None

    def update(self, frame_id: int, histogram: np.ndarray) -> np.ndarray | None:
        hist = np.asarray(histogram)[:, 0].astype(np.int64)
        if self.running is None:
            self.running = np.zeros_like(hist)
            snapshot = hist
        else:
            self.running += hist
            snapshot = self.running.copy()
        if frame_id % (self.update_interval * self.reset_interval) == 1:
            self.running[:] = 0
        if frame_id % self.update_interval != 1:
            return None
        self.params = peak_params(snapshot, self.params)
        return self.params.ranges()
