"""Share of the time the device was idle with the profiler off, from the
System's device stamps: 100 x (1 - union of the device.frame rows / the
first row's start to the last row's end), over the window's frames before
the profiled sub-window.  A device.frame row runs from the stamp before a
frame's copies in to the stamp after its copies out.

The frames read are the stream's first 64 window frames (the
harness's timing_frames: those up to the profiled sub-window's start),
after the harness has started and stopped a profiler once before the run
to warm it up.  They are no steady-state sample: they fall where the
window starts, where the card ran its slower regime in most runs so far,
and host spans read higher after a profiler has run than in a run that
never starts one (the profiler's residue).
"""

from benchmark.tracing import union_us


def read(rec):
    rows = [(s, e) for name, fid, _, s, e in rec.timing_rows
            if name == "device.frame" and fid in rec.timing_frames]
    if not rows:
        return None
    wall = max(e for _, e in rows) - min(s for s, _ in rows)
    return 100.0 * (1.0 - union_us(rows) / wall) if wall > 0 else None
