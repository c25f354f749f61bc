"""Median host time of a frame's fetch copy (the System's frame.fetch_copy
span, on the frame's fetch thread: from the end of the wait for the slot's
copies out to the fetched keys copied from the pinned slot into fresh numpy
arrays), over the window's frames before the profiled sub-window.

The frames read are the first 64 window frames (the harness's
timing_frames), after the harness has started and stopped a profiler once
before the run; see host_step_ms.py on what that leaves in host spans.
"""

import statistics


def read(rec):
    spans = [e - s for name, fid, _, s, e in rec.timing_rows
             if name == "frame.fetch_copy" and fid in rec.timing_frames]
    return statistics.median(spans) if spans else None
