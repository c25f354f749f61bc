"""Persistence-homology peak finding on 1-D histograms (host-side numpy).

Re-implementation of the reference's peak finder
(src/utils/peaks.cpp:12-72): indices are processed in order of descending
value; runs grow left/right; when two runs meet, the one with the smaller
birth value dies.  Peaks are returned sorted by persistence
(value[born] - value[died], infinite for the survivor).
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
        if self.died == -1:
            return float("inf")
        return float(data[self.born] - data[self.died])


def find_peaks(data: np.ndarray) -> list[Peak]:
    data = np.asarray(data).reshape(-1)
    n = data.shape[0]
    idx_to_peak = np.full(n, -1, dtype=np.int64)
    # Stable sort by descending value keeps ties in index order, matching
    # std::sort's comparator over a pre-sorted index array closely enough.
    order = np.argsort(-data, kind="stable")

    peaks: list[Peak] = []
    for idx in order:
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
        else:
            if data[peaks[il].born] > data[peaks[ir].born]:
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
