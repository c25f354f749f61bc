"""Median lag from a frame's dispatch to the start of its step on the
device: the start of the System's frame row to the start of the frame's
device.step row (the host's upload and graph launch, and the frame's copies
in on the device), over the window's frames before the profiled
sub-window.

In the camera cell these are the due frames up to the profiled
sub-window's start, most of the window; the harness has started and
stopped a profiler once before the run to warm it up, and host spans read
higher after that (the profiler's residue): this one 0.74-1.22 ms in
traced runs against 0.548 ms in a run that never starts a profiler (H100,
700 W).
"""

import statistics


def read(rec):
    steps = {fid: s for name, fid, _, s, _ in rec.timing_rows if name == "device.step"}
    lags = [steps[fid] - start for _, fid, _, start, _ in rec.frame_rows() if fid in steps]
    return statistics.median(lags) if lags else None
