"""Median host time of a frame's CUDA graph replay (the System's
frame.replay span: the ~1,145-node launch on the host), over the window's
frames before the profiled sub-window.

The frames read are the stream's first 64 window frames (the
harness's timing_frames: those up to the profiled sub-window's start),
after the harness has started and stopped a profiler once before the run
to warm it up.  They are no steady-state sample: they fall where the
window starts, where the card ran its slower regime in most runs so far,
and host spans read higher after a profiler has run than in a run that
never starts one (the profiler's residue).  This span
feels the residue most: 0.28-0.67 ms in traced runs against 0.04-0.11 ms
in runs that never start a profiler (H100, 700 W).
"""

import statistics


def read(rec):
    spans = [e - s for name, fid, _, s, e in rec.timing_rows
             if name == "frame.replay" and fid in rec.timing_frames]
    return statistics.median(spans) if spans else None
