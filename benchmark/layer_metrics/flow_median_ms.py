"""Device milliseconds a frame of the optical flow's 3x3 medians: the
kernels PyTorch runs for ``median(dim)`` (the flow's only median), matched
by these names."""

NAMES = ("gatherMedian",)


def read(rec):
    times = [e - s for name, s, e in rec.device_events if any(n in name for n in NAMES)]
    if not times or rec.frames <= 0:
        return None
    return sum(times) / 1e3 / rec.frames
