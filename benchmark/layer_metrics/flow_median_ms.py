"""Device milliseconds a stream frame of the optical flow's 3x3 medians,
whatever implements them: the program's hand-written kernel
(``median3x3_kernel``, csrc/median.cu, one launch a searched pyramid
level) or, before it, the kernels PyTorch runs for ``median(dim)``
(``gatherMedian``); matched by these names in the traced sub-window."""

NAMES = ("median3x3", "gatherMedian")


def read(rec):
    times = [e - s for name, s, e in rec.device_events if any(n in name for n in NAMES)]
    if not times or rec.frames <= 0:
        return None
    return sum(times) / 1e3 / rec.frames
