"""Median wait of a frame before the System dispatches it: from the
generator's due stamp to the start of the System's frame span, over the
window's frames outside the profiled sub-window."""

import statistics


def read(rec):
    waits = [start - rec.due_ms[fid] for _, fid, _, start, _ in rec.frame_rows()
             if fid in rec.due_ms]
    return statistics.median(waits) if waits else None
