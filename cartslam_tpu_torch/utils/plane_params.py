"""Plane parameter providers (host-side).

The classification ranges for plane segmentation come from either a static
config or the histogram-peak analyzer
(src/modules/planeseg/planeseg.cu:405-458).  Values are derivative-space
integers (histogram bin - 128).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from .peaks import find_peaks

log = logging.getLogger("cart.planeparams")


@dataclasses.dataclass
class PlaneParameters:
    """reference: include/modules/planeseg.hpp:25-34."""

    horizontal_range: tuple[int, int] = (0, 0)
    vertical_range: tuple[int, int] = (0, 0)
    horizontal_center: int = 0
    vertical_center: int = 0

    def ranges_array(self) -> np.ndarray:
        """int32 [2,2] for ops.planeseg.classify."""
        return np.array(
            [list(self.horizontal_range), list(self.vertical_range)], dtype=np.int32
        )


class PlaneParameterProvider:
    def get(self) -> PlaneParameters:
        raise NotImplementedError

    def update(self, histogram: np.ndarray) -> None:  # noqa: D401
        """Feed a 256-bin derivative histogram; may refresh parameters."""


class StaticPlaneParameterProvider(PlaneParameterProvider):
    """reference: include/modules/planeseg.hpp:106-113."""

    def __init__(self, horizontal_range, vertical_range):
        self.params = PlaneParameters(
            horizontal_range=tuple(horizontal_range),
            vertical_range=tuple(vertical_range),
            horizontal_center=(horizontal_range[0] + horizontal_range[1]) // 2,
            vertical_center=(vertical_range[0] + vertical_range[1]) // 2,
        )

    def get(self) -> PlaneParameters:
        return self.params


class HistogramPeakPlaneParameterProvider(PlaneParameterProvider):
    """Derive class ranges from the two most persistent histogram peaks.

    Mirrors HistogramPeakPlaneParameterProvider::updatePlaneParameters
    (planeseg.cu:405-458): the peak closest to bin 128 (derivative 0) is
    "vertical", the other "horizontal"; the valley between them splits the
    ranges; widths come from the peak-to-valley slope.
    """

    def __init__(self):
        self.params = PlaneParameters()

    def get(self) -> PlaneParameters:
        return self.params

    def update(self, histogram: np.ndarray) -> None:
        hist = np.asarray(histogram).reshape(-1).astype(np.int64)
        peaks = find_peaks(hist)
        if len(peaks) < 2:
            log.warning("histogram peak provider: not enough peaks found")
            return

        p0, p1 = peaks[0], peaks[1]
        if abs(p0.born - 128) > abs(p1.born - 128):
            p0, p1 = p1, p0
        # p0 = vertical (closest to zero derivative), p1 = horizontal.

        min_index = min(p0.born, p1.born)
        for i in range(min_index, max(p0.born, p1.born)):
            if hist[i] < hist[min_index]:
                min_index = i

        v_dist = abs(min_index - p0.born)
        h_dist = abs(min_index - p1.born)
        if v_dist == 0 or h_dist == 0:
            log.warning("histogram peak provider: zero min distance")
            return

        v_deriv = (hist[p0.born] - hist[min_index]) // v_dist
        h_deriv = (hist[p1.born] - hist[min_index]) // h_dist
        if v_deriv == 0 or h_deriv == 0:
            log.warning("histogram peak provider: zero slope")
            return

        v_width = int(hist[p0.born] // v_deriv)
        h_width = int(hist[p1.born] // h_deriv)

        self.params = PlaneParameters(
            vertical_range=(p0.born - v_width - 128, min_index - 127),
            horizontal_range=(min_index - 127, p1.born + h_width - 127),
            vertical_center=p0.born - 128,
            horizontal_center=p1.born - 128,
        )
