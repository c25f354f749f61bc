"""Median tail of a frame after its device work: the end of the frame's
device.frame row (the stamp after its copies out) to the end of the
System's frame row (its fetch done on the host: the event wait's wake-up
and the copy to numpy), over the window's frames before the profiled
sub-window."""

import statistics


def read(rec):
    ends = {fid: e for name, fid, _, _, e in rec.timing_rows if name == "device.frame"}
    tails = [end - ends[fid] for _, fid, _, _, end in rec.frame_rows() if fid in ends]
    return statistics.median(tails) if tails else None
