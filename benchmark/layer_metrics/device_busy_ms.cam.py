"""Device busy milliseconds a frame: the union of the device intervals in
the traced sub-window over its frames."""

from benchmark.tracing import busy_s


def read(rec):
    busy = busy_s(rec)
    if busy is None or rec.frames <= 0:
        return None
    return busy * 1e3 / rec.frames
