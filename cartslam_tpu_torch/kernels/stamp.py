"""The device stamp, csrc/stamp.cu, with its plain version.

Replaces no TPU kernel: it is the traced System's clock inside a frame's
CUDA graph replay.  ``stamp(row, k)`` writes the card's %globaltimer, in
nanoseconds, into slot k of the int64 row, in stream order, so the slot
holds the time at which the work enqueued before it on the stream had
ended.  Under capture the launch becomes a node of the graph and writes at
every replay.  A launch is one thread and 8 bytes; its cost is the launch.

On a CPU tensor the plain version writes the host clock (``clock``, in
nanoseconds, ``time.time_ns`` unless given), so the stamps and their
calibration (runtime/timing.fit_clock) run in the CPU tests.
"""

from __future__ import annotations

import time

import torch

from . import build

COUNTER = build.counter("stamp")


def stamp_plain(row: torch.Tensor, k: int, clock=time.time_ns) -> None:
    row[k] = clock()


@build.on_its_card
def stamp(row: torch.Tensor, k: int) -> None:
    """Write the device clock (ns) into row[k] (int64 [n]) on the current
    stream."""
    if not 0 <= k < row.numel():
        raise IndexError(f"stamp slot {k} outside a row of {row.numel()}")
    if row.device.type == "cpu":
        COUNTER.plain_calls += 1
        stamp_plain(row, k)
        return
    build.expect(row, "row", torch.int64)
    build.check(build.library().stamp(row.data_ptr(), k, build.stream()), "stamp")
    COUNTER.launches += 1
