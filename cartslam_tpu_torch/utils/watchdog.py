"""Bounded host fetches that cannot strand a worker pool (the port's copy
of cartslam_tpu/utils/watchdog.py).

The reference's 20 s data watchdog (src/utils/data.cpp:42-49) aborts a
wait, not the underlying work.  A fixed ThreadPoolExecutor reproduces
that badly: a timed-out ``np.asarray`` keeps its worker blocked forever,
and after ``max_workers`` hangs every *healthy* fetch queues behind dead
threads and times out too — one transient stall cascades into permanent
failure.  Instead each fetch gets a fresh daemon thread; a hung fetch
leaks exactly one thread (logged), and the next fetch starts unimpeded.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable

log = logging.getLogger("cartslam.watchdog")

_stranded = 0
_stranded_lock = threading.Lock()


def stranded_count() -> int:
    """Number of fetch threads abandoned by a timeout (still blocked)."""
    return _stranded


class FetchHandle:
    """An in-flight fetch running on its own daemon thread.

    ``start_fetch`` at dispatch time + ``result`` at drain time lets the
    device->host transfer latency overlap subsequent dispatches (the
    System's eager-drain pattern) instead of serializing the host loop on
    each fetch round trip.  ``done`` says whether the fetch thread has
    finished (a timed-out fetch may still hold its buffers).  ``span`` is
    (start, end) of the fetch on its thread, epoch ms (runtime/timing.py's
    clock), once it has finished: its end ends the System's frame row.
    """

    def __init__(self, fn: Callable[[], Any]):
        self._out: queue.Queue = queue.Queue(maxsize=1)
        self._abandoned = threading.Event()
        self._cached: tuple[bool, Any] | None = None
        self.span: tuple[float, float] | None = None
        t = threading.Thread(
            target=self._worker, args=(fn,), daemon=True, name="cart-fetch"
        )
        t.start()

    def _worker(self, fn):
        global _stranded
        start = round(time.time() * 1000, 3)
        try:
            val = (True, fn())
        except BaseException as e:  # delivered to the waiter
            val = (False, e)
        self.span = (start, round(time.time() * 1000, 3))
        self._out.put(val)
        with _stranded_lock:
            if self._abandoned.is_set():
                _stranded -= 1

    def done(self) -> bool:
        return self._cached is not None or not self._out.empty()

    def result(self, timeout: float) -> Any:
        """Block up to ``timeout`` seconds for the fetched value.

        Raises TimeoutError on expiry (the fetch thread is abandoned and
        counted, never cancelled).  Re-raises the fetch's own exception.
        """
        if self._cached is None:
            try:
                self._cached = self._out.get(timeout=timeout)
            except queue.Empty:
                with _stranded_lock:
                    global _stranded
                    _stranded += 1
                    self._abandoned.set()
                    n = _stranded
                log.warning(
                    "fetch exceeded %.1fs; abandoning its thread (%d stranded)",
                    timeout, n,
                )
                raise TimeoutError(f"fetch exceeded {timeout}s") from None
        ok, val = self._cached
        if ok:
            return val
        raise val


def start_fetch(fn: Callable[[], Any]) -> FetchHandle:
    """Begin ``fn`` on a fresh daemon thread; join it with .result()."""
    return FetchHandle(fn)


def run_with_timeout(fn: Callable[[], Any], timeout: float) -> Any:
    """Run ``fn`` on a fresh daemon thread; raise TimeoutError if it
    does not finish within ``timeout`` seconds.

    The thread is not (cannot be) cancelled — it is abandoned and
    counted, so observability surfaces accumulating stranded workers
    while healthy fetches stay unaffected.
    """
    return FetchHandle(fn).result(timeout)
