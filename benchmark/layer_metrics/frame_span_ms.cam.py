"""Median of the System's own frame spans: from a frame's dispatch
(TimingWriter's ``mark_start``) to the end of its fetch (the fetch thread's
``t_end_ms``), over the window's frames outside the profiled sub-window."""

import statistics


def read(rec):
    spans = [end - start for _, _, _, start, end in rec.frame_rows()]
    return statistics.median(spans) if spans else None
