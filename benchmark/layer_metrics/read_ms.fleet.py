"""Median host milliseconds of a round's read in the multi-sequence mode:
the System's frame.read rows (prefetch thread: from the first source's
get_next to the round's B pairs stacked into newly allocated [B, ...]
pinned buffers), over the window's rounds before the profiled sub-window.

A round's read runs on the prefetch thread, ahead of the rounds in flight;
it paces the card only where it takes longer than the card's round."""

import statistics


def read(rec):
    spans = [e - init for name, fid, init, _, e in rec.timing_rows
             if name == "frame.read" and fid in rec.timing_frames]
    return statistics.median(spans) if spans else None
