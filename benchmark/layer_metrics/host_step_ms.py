"""Median host time of a drained frame's host step (the System's
frame.host_step span: the modules' host updates, the histogram-peak
provider among them), over the window's frames before the profiled
sub-window.

The frames read are the stream's first 64 window frames (the
harness's timing_frames: those up to the profiled sub-window's start),
after the harness has started and stopped a profiler once before the run
to warm it up.  They are no steady-state sample: they fall where the
window starts, where the card ran its slower regime in most runs so far,
and host spans read higher after a profiler has run than in a run that
never starts one (the profiler's residue).
"""

import statistics


def read(rec):
    spans = [e - s for name, fid, _, s, e in rec.timing_rows
             if name == "frame.host_step" and fid in rec.timing_frames]
    return statistics.median(spans) if spans else None
