"""Share of the traced sub-window in which no operation ran on the device:
100 x (1 - union of the device intervals / the sub-window's wall time)."""

from benchmark.tracing import busy_s


def read(rec):
    busy = busy_s(rec)
    if busy is None or rec.wall_s <= 0:
        return None
    return 100.0 * (1.0 - busy / rec.wall_s)
