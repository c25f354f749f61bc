"""CSV timing instrumentation with the reference's exact file contract (the
port's copy of cartslam_tpu/runtime/timing.py).

Columns `name;run_id;time_init;time_start;time_end;duration_ms` written to
timing/timing-<timestamp>.csv (reference: include/timing.hpp:41-70,
include/utils/csv.hpp).  Three granularities are produced by the System:
whole-system, per-frame, and per-module (init = submit time, start = after
dependencies resolve), matching src/cartslam.cpp:233-251.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field


def _now_ms() -> float:
    # Sub-ms precision: per-module device stages run well under 1 ms, so the
    # reference's integer-ms epochs would round them to zero.
    return round(time.time() * 1000, 3)


@dataclass
class TimingHandle:
    name: str
    run_id: int
    init: float = field(default_factory=_now_ms)
    start: float = 0
    end: float = 0

    def begin(self):
        self.start = _now_ms()
        return self

    def mark_start(self, at_ms: float | None = None):
        self.start = at_ms if at_ms is not None else _now_ms()


class TimingWriter:
    SEP = ";"
    HEADER = ["name", "run_id", "time_init", "time_start", "time_end", "duration_ms"]

    def __init__(self, directory: str = "timing", enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._file = None
        if enabled:
            os.makedirs(directory, exist_ok=True)
            fname = "timing-" + time.strftime("%d.%m.%Y %H:%M:%S") + ".csv"
            self._path = os.path.join(directory, fname)
            self._file = open(self._path, "w")
            self._file.write(self.SEP.join(self.HEADER) + "\n")

    def init_timing(self, name: str, run_id: int) -> TimingHandle:
        return TimingHandle(name, run_id)

    def end_timing(self, handle: TimingHandle):
        handle.end = _now_ms()
        self.end_timing_at(handle)

    def end_timing_at(self, handle: TimingHandle):
        """Write a row whose init/start/end were set by the caller."""
        if not self.enabled or self._file is None:
            return
        row = [
            handle.name,
            str(handle.run_id),
            str(handle.init),
            str(handle.start),
            str(handle.end),
            str(round(handle.end - handle.start, 3)),
        ]
        with self._lock:
            self._file.write(self.SEP.join(row) + "\n")
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
