"""CSV timing instrumentation with the reference's exact file contract (the
port's copy of cartslam_tpu/runtime/timing.py), and the System's spans and
device stamps that go out through it.

Columns `name;run_id;time_init;time_start;time_end;duration_ms` written to
timing/timing-<timestamp>.csv (reference: include/timing.hpp:41-70,
include/utils/csv.hpp); `init` is when the work was asked for, `start` when
it began.  Every time is on one clock: ``time.time()``, epoch milliseconds
with three decimals, the clock of torch.profiler's host events (kineto's
``time.time_ns``).  The rows the System writes:

  * `system` (run_id 0): the whole run;
  * `frame`: a frame's dispatch to the end of its fetch;
  * under ``module_timing`` (the eager step, a sync per module) one row a
    module, named by the module (`ImageDisparity`, ...), as the JAX System
    writes them (src/cartslam.cpp:233-251).

A System given a writer and no ``module_timing`` traces, and adds, with
run_id the frame id:

  * host spans: `frame.read` (prefetch thread: get_next called, returned,
    the pinned images queued), `frame.handoff` (queued to the main thread's
    get), `frame.upload` (host params if changed, the frame's copies in),
    `frame.capture` (a variant's capture, where one ran), `frame.replay`
    (the CUDA graph replay; `frame.step` on the eager path), `frame.stage`
    (slot, copies out, event), `frame.fetch_wait` and `frame.fetch_copy`
    (fetch thread: the event wait, the copy to numpy), `frame.join` (the
    main thread's wait for the fetch), `frame.host_step` (the modules' host
    updates and host modules), `frame.deliver` (the caller's on_frame),
    `system.snapshot` and `system.checkpoint` (a drain and a host copy of
    the state);
  * device rows from the stamps of the captured single-sequence step
    (kernels/stamp.py), mapped onto the host clock by ``fit_clock``:
    `device.frame` (copies in, step, copies out), `device.step` (the
    graph's modules) and `device.<module>` (from the previous stamp to the
    module's end).

While a torch.profiler runs on the main thread, each host span made there is
also a host range named `cart.<span>` in the profile (``host_range``; the
profiler is thread-local: the prefetch and fetch threads' spans are rows
only, and so is `frame.capture`, known to be one only once the capture ran).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field

import torch

from ..kernels.stamp import stamp

# A host range for the profiler: a plain op range (`cpu_op`).  A user
# annotation (torch.profiler.record_function) would also be drawn on the
# device's timeline over the kernels it launched (kineto's
# gpu_user_annotation), where it would count as a device operation.
host_range = torch._C._profiler._RecordFunctionFast


def now_ms() -> float:
    # Sub-ms precision: per-module device stages run well under 1 ms, so the
    # reference's integer-ms epochs would round them to zero.
    return round(time.time() * 1000, 3)


@dataclass
class TimingHandle:
    name: str
    run_id: int
    init: float = field(default_factory=now_ms)
    start: float = 0
    end: float = 0

    def begin(self):
        self.start = now_ms()
        return self

    def mark_start(self, at_ms: float | None = None):
        self.start = at_ms if at_ms is not None else now_ms()


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
        handle.end = now_ms()
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


# ----------------------------------------------------------- host spans

class Span:
    """``with Span(spans, name):`` the block as spans[name] = (start, start,
    end), and as a host range `cart.<name>` while a profiler runs on this
    thread; nothing where spans is None (a System that does not trace)."""

    __slots__ = ("spans", "name", "start", "range")

    def __init__(self, spans: dict | None, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        if self.spans is not None:
            self.start = now_ms()
            self.range = None
            if torch.autograd._profiler_enabled():
                self.range = host_range("cart." + self.name)
                self.range.__enter__()

    def __exit__(self, *exc):
        if self.spans is not None:
            self.spans[self.name] = (self.start, self.start, now_ms())
            if self.range is not None:
                self.range.__exit__(None, None, None)


def write_spans(writer: TimingWriter, run_id: int, spans: dict) -> None:
    for name, (init, start, end) in spans.items():
        writer.end_timing_at(TimingHandle(name, run_id, init, start, end))


# -------------------------------------------------------- device stamps

@dataclasses.dataclass(frozen=True)
class ClockFit:
    """host epoch ns = device ns + offset_ns, within +- error_ns."""

    offset_ns: int
    error_ns: int

    def to_ms(self, device_ns: int) -> float:
        return round((int(device_ns) + self.offset_ns) / 1e6, 3)


def fit_clock(stamp, sync, read, rounds: int = 12, clock=time.time_ns) -> ClockFit:
    """The device clock against the host's: `rounds` rounds of host clock,
    stamp(i) (device time into slot i), sync(), host clock; read() then
    returns the slots.  The round with the shortest host interval is kept:
    its stamp fell inside that interval, taken at its midpoint."""
    marks = []
    for i in range(rounds):
        h0 = clock()
        stamp(i)
        sync()
        marks.append((h0, clock()))
    (h0, h1), d = min(zip(marks, read()), key=lambda m: m[0][1] - m[0][0])
    return ClockFit((h0 + h1) // 2 - int(d), (h1 - h0 + 1) // 2)


class StampRow:
    """The device stamps of a traced single-sequence frame: one int64 row
    (StaticBuffers.stamps), each slot written by kernels/stamp.py in stream
    order.  ``frame_in`` (before the frame's copies in) and ``frame_out``
    (after its copies out) are launched eagerly by the System;
    ``step_start`` and ``after_module(i)`` are nodes of the captured step."""

    def __init__(self, modules: int, device):
        self.row = torch.zeros(modules + 3, dtype=torch.int64, device=device)

    def frame_in(self) -> None:
        stamp(self.row, 0)

    def step_start(self) -> None:
        stamp(self.row, 1)

    def after_module(self, i: int) -> None:
        stamp(self.row, 2 + i)

    def frame_out(self) -> None:
        stamp(self.row, len(self.row) - 1)

    @staticmethod
    def spans(stamps, fit: ClockFit, modules: list[str]) -> dict:
        """A frame's copy of the row as spans on the host clock:
        device.frame, device.step and device.<module> (from the previous
        stamp to the module's)."""
        t = [fit.to_ms(s) for s in stamps]
        spans = {"device.frame": (t[0], t[0], t[-1]), "device.step": (t[1], t[1], t[-2])}
        for i, name in enumerate(modules):
            spans[f"device.{name}"] = (t[1 + i], t[1 + i], t[2 + i])
        return spans
