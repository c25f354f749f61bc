"""System: the host loop around the pipeline step (counterpart of
cartslam_tpu/runtime/system.py).

Replaces the reference's System scheduler (src/cartslam.cpp:179-334): the
thread pool and promise store become a bounded queue of dispatched steps
(``max_in_flight``) whose results are fetched on watchdog threads, and run
retention becomes the host-visible ring of fetched runs.

On the card each frame is one replay of the step's CUDA graph for its
variant (``Pipeline.captured_step`` or ``SpatialPipeline.captured_step``,
runtime/graphs.py), the counterpart of JAX's ``jitted_step``; the first
frame of each variant includes its capture.  The frame goes through pinned
host memory into the static frame buffers; after the replay, the fetch
keys' outputs are copied into one of ``max_in_flight`` pinned slots on the
same stream and an event is recorded, and a fetch thread waits on that
event under the data watchdog.  With a CPU context or with
``module_timing`` the System runs the eager step instead (the caller's
choice, not a fallback).

The drain order is the JAX System's: frame t is drained, and its modules'
``host_update`` runs, once frame t + max_in_flight - 1 has been dispatched,
so a frame sees exactly the host params (e.g. the plane ranges) the JAX
System gives it.  ``runtime/loop.run`` is the synchronous form,
``max_in_flight=1``.

Given a TimingWriter (and no ``module_timing``) the System traces: each
frame's host phases as spans and, on the captured single-sequence step, its
device time from stamps inside the replay, all as the writer's rows
(runtime/timing.py names them).  ``System.counters`` counts fetched bytes,
fetch threads, captures and pinned host allocations in every run.

Failure semantics follow the reference: one bad frame logs and continues
(src/main.cpp:48-54).  A frame whose execution fails poisons the state the
frames dispatched after it read, so recovery restores the last known-good
state snapshot and resumes.  A result fetch that hangs raises
DataNotAvailableException after ``data_timeout`` seconds, the 20 s watchdog
of src/utils/data.cpp:42-49.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import queue
import threading
import time
import traceback
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from ..kernels.stamp import stamp
from ..sources.base import to_grayscale
from .checkpoint import load_checkpoint, save_checkpoint
from .graphs import CapturedStep, CaptureError, StaticBuffers, capture_cards
from .module import HostModule
from .pipeline import Pipeline
from .state import state_from_reference, state_to_numpy
from .timing import ClockFit, Span, StampRow, TimingWriter, fit_clock, now_ms, write_spans
from ..utils.watchdog import start_fetch

log = logging.getLogger("cart.system")


class DataNotAvailableException(RuntimeError):
    """A frame's results did not materialize within the data timeout
    (the reference's DataNotAvailableException, include/utils/data.hpp:11)."""


# Rounds of the device clock's fit (timing.fit_clock).
CLOCK_ROUNDS = 12


class _Slot:
    """Host buffers of one in-flight frame's fetch keys (pinned on a card),
    and the events recorded after their device-to-host copies (one on each
    card that holds a part).  Traced: the frame's device stamps, and when
    the fetch thread's event wait ended (epoch ms)."""

    def __init__(self):
        self.host: dict[str, torch.Tensor] = {}
        self.events: list[torch.cuda.Event] = []
        self.stamps: torch.Tensor | None = None
        self.waited = 0.0


def _on(device):
    """The device's scope on a card: its current stream becomes the one
    that work is enqueued on."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _failed(error: BaseException):
    raise error


class System:
    """Drives frames from a DataSource through a Pipeline.

    Args (the JAX System's, with its defaults):
        source: DataSource (sources.base.DataSource).
        pipeline: composed Pipeline (or SpatialPipeline).
        host_modules: visualization / recording consumers.
        max_in_flight: dispatched-but-unfetched frames.
        prefetch_depth: host frame decode look-ahead.
        timing: where the rows go (runtime/timing.py).  Given a writer and
            no module_timing, the System traces: host spans and, on the
            captured single-sequence step, device stamps.
        module_timing: run module by module with a sync per module,
            emitting a per-module CSV timing row (eager step).
        data_timeout: seconds before a hung result fetch raises
            DataNotAvailableException (reference: 20 s).
        snapshot_interval: frames between host snapshots of the state used
            for failed-frame recovery; 0 disables recovery snapshots.
        run_retention: fetched runs kept reachable by id.
    """

    batch = 1  # frames a round: the multi-sequence System's B
    # System.counters: plain integers of a run, no clock read.  fetched_bytes:
    # the fetched arrays' bytes; fetch_threads: fetch threads started;
    # captures: step variants captured; pinned_host_allocs: pinned host
    # blocks the caching allocator made (torch.cuda.host_memory_stats'
    # num_host_alloc at run() end less at its start).
    COUNTERS = ("fetched_bytes", "fetch_threads", "captures", "pinned_host_allocs")

    def __init__(
        self,
        source,
        pipeline,
        host_modules: Iterable[HostModule] = (),
        *,
        max_in_flight: int = 4,
        prefetch_depth: int = 12,
        timing: TimingWriter | None = None,
        image_sink=None,
        max_frames: int | None = None,
        extra_fetch_keys: Iterable[str] = (),
        checkpoint_path: str | None = None,
        checkpoint_interval: int = 100,
        resume_from: str | None = None,
        module_timing: bool = False,
        data_timeout: float = 20.0,
        snapshot_interval: int = 64,
        run_retention: int = 32,
    ):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.source = source
        self.pipeline = pipeline
        self.host_modules = list(host_modules)
        self.max_in_flight = max_in_flight
        self.prefetch_depth = prefetch_depth
        self.timing = timing or TimingWriter(enabled=False)
        self.tracing = timing is not None and not module_timing
        self.counters = dict.fromkeys(self.COUNTERS, 0)
        # Traced, captured: the device clock's fits at the run's start and end.
        self.clock_fits: list[ClockFit] = []
        self.image_sink = image_sink
        self.max_frames = max_frames
        self.checkpoint_path = checkpoint_path
        self.checkpoint_interval = checkpoint_interval
        self.resume_from = resume_from
        self.module_timing = module_timing
        self.data_timeout = data_timeout
        self.snapshot_interval = snapshot_interval
        self.global_data: dict[str, Any] = {}
        self.failed_frames: list[int] = []
        # Reference: ring of the last CARTSLAM_RUN_RETENTION=32 runs,
        # reachable by id (include/cartslam.hpp:3, System::getRunById).
        self.run_retention = run_retention
        self._retained: collections.OrderedDict[int, dict] = collections.OrderedDict()
        self.final_state = None

        self._fetch_keys = frozenset(
            set(pipeline.host_fetch_keys())
            | {d.key for hm in self.host_modules for d in hm.requires()}
            | set(extra_fetch_keys)
        )
        self.device = pipeline.ctx.device
        # On a card the step is captured, one graph over every card it runs
        # on (graphs.capture_cards); module timing runs it eagerly.
        self.captured = not module_timing and bool(capture_cards(self.device, pipeline.devices))

        self._prefetch_queue: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self._prefetch_error: BaseException | None = None
        self._stop = threading.Event()
        self._free_slots: list[_Slot] = []
        self._params_version = 0  # bumped by every host-param update
        self._stamps: StampRow | None = None  # StaticBuffers.stamps, traced
        self._read_got = 0.0  # traced: when the prefetch thread's get_next returned

    # ------------------------------------------------------------ global data

    def insert_global_data(self, key: str, value: Any):
        """reference: System::insertGlobalData (include/cartslam.hpp:84)."""
        self.global_data[key] = value

    def get_global_data(self, key: str) -> Any:
        return self.global_data[key]

    def get_run_by_id(self, frame_id: int) -> Mapping[str, np.ndarray]:
        """Fetched outputs of a retained run (System::getRunById parity).
        Raises KeyError for ids outside the retention window, as the
        reference throws for too-old / too-new ids (src/cartslam.cpp:210-222)."""
        return self._retained[frame_id]

    def _retain(self, frame_id: int, fetched) -> None:
        if not self.run_retention:
            return
        self._retained[frame_id] = fetched
        while len(self._retained) > self.run_retention:
            self._retained.popitem(last=False)

    # -------------------------------------------------------------- prefetch

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._prefetch_queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _read(self):
        """The next frame as (host frame, its images as tensors, pinned on a
        card), or None at the end of the source.  The grayscale switch
        converts the frames at the source boundary, as the JAX System does."""
        if self.source.is_finished():
            return None
        frame = self.source.get_next()
        if self.tracing:
            self._read_got = now_ms()
        if frame is None:
            return None
        if self.pipeline.ctx.grayscale:
            frame = to_grayscale(frame)
        images = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in frame.items() if isinstance(v, np.ndarray)}
        if self.device.type == "cuda":
            images = {k: v.pin_memory() for k, v in images.items()}
        return frame, images

    def _prefetch_worker(self):
        """Decode ahead; on a card, stage each frame's images in pinned host
        memory, from which the main thread copies them without waiting.
        (PyTorch's pinned-memory cache reuses a block only after the copy
        that read it is done.)  Each item is (host frame, images, its
        frame.read span or None)."""
        try:
            while not self._stop.is_set():
                asked = now_ms() if self.tracing else 0.0
                item = self._read()
                if item is None:
                    break
                read = (asked, self._read_got, now_ms()) if self.tracing else None
                if not self._put((*item, read)):
                    break
        except BaseException as e:  # surfaced in run()
            self._prefetch_error = e
        finally:
            self._put(None)

    # --------------------------------------------------------------- fetching

    def _stage(self, outputs: Mapping[str, torch.Tensor | list]) -> _Slot:
        """Enqueue the fetch keys' device-to-host copies into a free slot's
        host buffers on the current stream, and record an event after them.
        An output may be a list of batch-leading parts (the partitions of
        the multi-sequence System, parallel/system.py): they go into
        consecutive rows of one buffer, each part's copy on its own card's
        current stream, with an event on each card.  A slot returns to the
        free list only once its fetch was joined."""
        slot = self._free_slots.pop() if self._free_slots else _Slot()
        pin = self.device.type == "cuda"
        devices = []
        for k, v in outputs.items():
            parts = v if isinstance(v, list) else [v]
            shape = (sum(len(p) for p in parts), *parts[0].shape[1:]) if isinstance(v, list) \
                else v.shape
            buf = slot.host.get(k)
            if buf is None or buf.shape != shape or buf.dtype != parts[0].dtype:
                buf = slot.host[k] = torch.empty(shape, dtype=parts[0].dtype, pin_memory=pin)
            if not isinstance(v, list):
                buf.copy_(v, non_blocking=pin)
                continue
            row = 0
            for p in parts:
                with _on(p.device):
                    buf[row:row + len(p)].copy_(p, non_blocking=pin)
                row += len(p)
                if p.device not in devices:
                    devices.append(p.device)
        for k in set(slot.host) - set(outputs):
            del slot.host[k]
        if self._stamps is not None:
            self._stamps.frame_out()
            row = self._stamps.row
            if slot.stamps is None:
                slot.stamps = torch.empty(row.shape, dtype=row.dtype, pin_memory=True)
            slot.stamps.copy_(row, non_blocking=True)
        if pin:
            slot.events = []
            for dev in devices or [self.device]:
                with _on(dev):
                    slot.events.append(torch.cuda.Event())
                    slot.events[-1].record()
        return slot

    def _fetch_with_timeout(self, staged: _Slot) -> dict[str, np.ndarray]:
        """Materialize a frame's staged outputs on the host (runs on the
        fetch thread): wait for the slot's event, then copy the buffers out.

        The data-watchdog bound is applied when the result is JOINED
        (_join_fetch), not here; fault-injection tests patch this method
        to simulate hung or failing transfers."""
        for event in staged.events:
            event.synchronize()
        if self.tracing:
            staged.waited = now_ms()
        return {k: v.numpy().copy() for k, v in staged.host.items()}

    def _start_fetch(self, staged: _Slot):
        """Begin the fetch on its own daemon thread at dispatch time, so the
        wait for frame N overlaps the dispatch of frames N+1..N+k; a hung
        fetch is abandoned at join time (utils/watchdog.py)."""
        self.counters["fetch_threads"] += 1
        return start_fetch(lambda: self._fetch_with_timeout(staged))

    def _join_fetch(self, fetch_handle) -> dict[str, np.ndarray]:
        """Join an eager fetch, bounded by the data watchdog (20 s)."""
        try:
            return fetch_handle.result(self.data_timeout)
        except TimeoutError:
            raise DataNotAvailableException(
                f"frame results not available within {self.data_timeout}s"
            ) from None

    # ------------------------------------------------------------------- run

    def run(self, on_frame: Callable[[int, Mapping[str, np.ndarray]], None] | None = None):
        """Process the whole sequence; returns the number of frames processed."""
        self._stop.clear()
        thread = threading.Thread(target=self._prefetch_worker, daemon=True,
                                  name="cart-prefetch")
        try:
            return self._run(thread, on_frame)
        finally:
            self._stop.set()
            if thread.is_alive():
                thread.join(timeout=10)

    # ------------------------------------------- what the multi-sequence
    # System (parallel/system.py) overrides: its frames, its state and
    # steps over partitions of the batch, its host step across processes

    def _sources(self) -> list:
        return [self.source]

    def _initial_state(self) -> dict:
        return self.pipeline.init_state()

    def _static_buffers(self, frame_np):
        return self.pipeline.static_buffers(frame_np)

    def _captured_step(self, variant):
        return self.pipeline.captured_step(variant, self._fetch_keys)

    def _eager_frame(self, state, images, frame_id: int, params, variant):
        """The eager step of one frame, its images moved to the device:
        (new state, the fetch keys' outputs); with module_timing, module by
        module with a timing row each."""
        dev = self.device
        frame_dev = {k: v.to(dev, non_blocking=True) for k, v in images.items()}
        frame_dev["frame_id"] = torch.full((), frame_id, dtype=torch.int32, device=dev)
        if self.module_timing:
            state, outputs, mod_times = self.pipeline.run_step_instrumented(
                state, frame_dev, params, variant, self._fetch_keys)
            self._emit_module_rows(frame_id, mod_times)
            return state, outputs
        state, outputs = self.pipeline.step(state, frame_dev, params, variant)
        return state, {k: v for k, v in outputs.items() if k in self._fetch_keys}

    def _device_params(self, host_params):
        return self.pipeline.device_params(host_params)

    def _device_state(self, tree):
        """A state tree of host arrays as the eager step's state."""
        return state_from_reference(tree, self.device)

    def _host_state(self, state):
        """The eager step's (or the static buffers') state as host arrays."""
        return state_to_numpy(state)

    def _load_checkpoint(self, example):
        return load_checkpoint(self.resume_from, example)

    def _save_checkpoint(self, state, frame_id: int) -> None:
        save_checkpoint(self.checkpoint_path, state, frame_id,
                        {m.name: m.host_state() for m in self.pipeline.modules})

    def _agree(self, frame_id: int, fetched: dict | None) -> dict | None:
        """The fetched data the modules' host steps read, or None when the
        frame failed.  The multi-process System (parallel/system.py) makes
        every process agree on both."""
        return fetched

    # Whether a frame that fails at dispatch is recorded only when it is
    # drained, in order, as the processes of a multi-process run must.
    _fail_in_order = False

    # ------------------------------------------------------------------- run

    def _run(self, thread, on_frame):
        pipe = self.pipeline
        tr = self.tracing
        self.counters = dict.fromkeys(self.COUNTERS, 0)
        pinned_at_start = self._pinned_allocs()
        start_frame = 0
        state = self._initial_state()
        if self.resume_from is not None:
            raw, start_frame, host_state = self._load_checkpoint(self._host_state(state))
            state = self._device_state(raw)
            for m in pipe.modules:
                if m.name in host_state:
                    m.restore_host_state(host_state[m.name])
            for source in self._sources():
                if hasattr(source, "skip"):
                    source.skip(start_frame)
            log.info("resumed from %s at frame %d", self.resume_from, start_frame)
        host_params = pipe.init_host_params()
        # The params the step reads live on the device; they are written
        # again only when a host step changed them (version counter).
        uploaded = {"version": -1, "params": None}
        bufs = None  # the captured step's static buffers, made at frame 1

        def set_state(tree):
            nonlocal state
            if bufs is not None:
                bufs.load_state(tree)
            else:
                state = self._device_state(tree)

        def current_state():
            return bufs.state if bufs is not None else state

        thread.start()
        in_flight: collections.deque = collections.deque()
        frame_id = start_frame
        processed = 0
        # Recovery snapshot: the last known-good host copy of the state.
        snap_state = self._host_state(state) if self.snapshot_interval else None
        need_recovery = False

        sys_handle = self.timing.init_timing("system", 0).begin()

        def drain_one() -> bool:
            """Fetch + host-process the oldest in-flight frame.  Returns
            False when the frame failed (device error or watchdog timeout):
            the caller must then recover the state."""
            nonlocal processed
            fid, handle, frame_np, fetch_handle, slot, spans = in_flight.popleft()
            try:
                with Span(spans, "frame.join"):
                    fetched = self._join_fetch(fetch_handle)
            except Exception:
                log.error("frame %d failed (async):\n%s", fid, traceback.format_exc())
                fetched = None
                if fetch_handle.done() and slot is not None:  # a hung fetch may
                    self._free_slots.append(slot)               # still write its slot
            else:
                if spans is not None:
                    self._fetch_spans(spans, fetch_handle, slot)
                self._free_slots.append(slot)
            agreed = self._agree(fid, fetched)
            if agreed is None:
                if fetched is not None:
                    log.error("frame %d failed on another process", fid)
                self.failed_frames.append(fid)
                return False
            # End the frame's timing row at the fetch's completion time.
            handle.end = fetch_handle.span[1]
            self.timing.end_timing_at(handle)
            self.counters["fetched_bytes"] += sum(v.nbytes for v in fetched.values())
            self._retain(fid, fetched)
            try:
                with Span(spans, "frame.host_step"):
                    self._host_post_frame(fid, frame_np, fetched, host_params, agreed)
            except Exception:
                log.error("frame %d host processing failed:\n%s", fid, traceback.format_exc())
            if on_frame is not None:
                with Span(spans, "frame.deliver"):
                    on_frame(fid, fetched)
            if spans is not None:
                write_spans(self.timing, fid, spans)
            processed += self.batch
            return True

        def drain_all():
            nonlocal need_recovery
            while in_flight:
                if not drain_one():
                    need_recovery = True

        while True:
            if need_recovery:
                # The frames dispatched after the failed one read a poisoned
                # state.  Drop them and restart from the last good snapshot.
                drain_all()
                need_recovery = False
                if snap_state is not None:
                    set_state(snap_state)
                    log.warning("recovered pipeline state from snapshot")
                else:
                    set_state(self._host_state(self._initial_state()))
                    log.warning("no snapshot available; state re-initialized")

            item = self._prefetch_queue.get()
            got = now_ms() if tr else 0.0
            if item is None:
                break
            frame_np, images, read = item
            frame_id += 1
            if self.max_frames is not None and frame_id > self.max_frames:
                break

            handle = self.timing.init_timing("frame", frame_id)
            variant = pipe.variant(frame_id)
            handle.mark_start()
            spans = {"frame.read": read, "frame.handoff": (read[2], read[2], got)} if tr else None
            try:
                if self.captured:
                    if bufs is None:
                        bufs = self._static_buffers(frame_np)
                        bufs.load_state(state)
                        state = None
                        if tr:
                            self._add_stamps(bufs)
                    with Span(spans, "frame.upload"):
                        if uploaded["version"] != self._params_version:
                            bufs.load_params(host_params)
                            uploaded["version"] = self._params_version
                        if self._stamps is not None:
                            self._stamps.frame_in()
                        bufs.load_frame(images, frame_id)
                    made, asked = CapturedStep.made, now_ms() if tr else 0.0
                    step = self._captured_step(variant)
                    if CapturedStep.made != made:
                        self.counters["captures"] += CapturedStep.made - made
                        if tr:
                            spans["frame.capture"] = (asked, asked, now_ms())
                    with Span(spans, "frame.replay"):
                        outputs = step()
                else:
                    with Span(spans, "frame.upload"):
                        if uploaded["version"] != self._params_version:
                            uploaded["params"] = self._device_params(host_params)
                            uploaded["version"] = self._params_version
                    with Span(spans, "frame.step"):
                        state, outputs = self._eager_frame(state, images, frame_id,
                                                           uploaded["params"], variant)
                with Span(spans, "frame.stage"):
                    slot = self._stage(outputs)
            except CaptureError:
                raise
            except Exception as e:
                log.error("frame %d failed:\n%s", frame_id, traceback.format_exc())
                if self._fail_in_order:
                    self.counters["fetch_threads"] += 1
                    in_flight.append((frame_id, handle, frame_np,
                                      start_fetch(functools.partial(_failed, e)), None, None))
                    continue
                self.failed_frames.append(frame_id)
                need_recovery = True
                continue

            in_flight.append((frame_id, handle, frame_np, self._start_fetch(slot), slot, spans))
            while len(in_flight) >= self.max_in_flight:
                if not drain_one():
                    need_recovery = True
                    break

            if (not need_recovery and self.snapshot_interval
                    and frame_id % self.snapshot_interval == 0):
                sys_spans = {} if tr else None
                with Span(sys_spans, "system.snapshot"):
                    drain_all()  # ensure the snapshot state is actually good
                    if not need_recovery:
                        snap_state = self._host_state(current_state())
                if tr:
                    write_spans(self.timing, frame_id, sys_spans)

            if (not need_recovery and self.checkpoint_path is not None
                    and frame_id % self.checkpoint_interval == 0):
                # Drain so the modules' host state (running histograms,
                # provider ranges) matches the saved device state.
                sys_spans = {} if tr else None
                with Span(sys_spans, "system.checkpoint"):
                    drain_all()
                    if not need_recovery:
                        self._save_checkpoint(current_state(), frame_id)
                if tr:
                    write_spans(self.timing, frame_id, sys_spans)

        drain_all()

        self.timing.end_timing(sys_handle)
        self.counters["pinned_host_allocs"] = self._pinned_allocs() - pinned_at_start
        if self.clock_fits:
            self._refit_clock()
        if self._prefetch_error is not None:
            raise self._prefetch_error
        self.final_state = self._host_state(current_state())
        return processed

    # ---------------------------------------------------------------- tracing

    def _add_stamps(self, bufs) -> None:
        """Traced: the captured single-sequence step's device stamps (the
        spatial and batched steps take none), and the device clock's fit."""
        if not (isinstance(bufs, StaticBuffers) and isinstance(self.pipeline, Pipeline)):
            return
        if bufs.stamps is None and self.pipeline.captured_steps:
            return  # its graphs were captured without stamps
        bufs.add_stamps(len(self.pipeline.modules))
        self._stamps = bufs.stamps
        self.clock_fits = [self._fit_clock()]

    def _fit_clock(self) -> ClockFit:
        row = torch.zeros(CLOCK_ROUNDS, dtype=torch.int64, device=self.device)
        return fit_clock(lambda i: stamp(row, i), lambda: torch.cuda.synchronize(self.device),
                         row.tolist, CLOCK_ROUNDS)

    def _refit_clock(self) -> None:
        """The device clock fitted again at the run's end: its drift since
        the start, against the two fits' errors, in the log."""
        start = self.clock_fits[0]
        end = self._fit_clock()
        self.clock_fits.append(end)
        log.info("device clock: drift %d ns over the run (offset %d -> %d ns), error +-%d / "
                 "+-%d ns", end.offset_ns - start.offset_ns, start.offset_ns, end.offset_ns,
                 start.error_ns, end.error_ns)

    def _fetch_spans(self, spans: dict, fetch_handle, slot: _Slot) -> None:
        """A joined frame's fetch-thread spans and device rows: the event
        wait and the copy, ended by the fetch's own end, and the stamps on
        the host clock."""
        begun, ended = fetch_handle.span
        if slot.waited:
            spans["frame.fetch_wait"] = (begun, begun, slot.waited)
            spans["frame.fetch_copy"] = (slot.waited, slot.waited, ended)
        if slot.stamps is not None and self.clock_fits:
            spans.update(StampRow.spans(slot.stamps.tolist(), self.clock_fits[0],
                                        [m.name for m in self.pipeline.modules]))

    def _pinned_allocs(self) -> int:
        """Pinned host blocks the caching host allocator has made so far."""
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0))

    # --------------------------------------------------------- host callbacks

    def _emit_module_rows(self, frame_id: int, mod_times):
        """Write per-module CSV rows (name;run_id;init;start;end;duration)."""
        # Map perf_counter seconds onto the epoch-ms clock the CSV uses.
        base = time.time() * 1000 - time.perf_counter() * 1000
        for name, t_init, t_start, t_end in mod_times:
            h = self.timing.init_timing(name, frame_id)
            h.init = round(base + t_init * 1000, 3)
            h.start = round(base + t_start * 1000, 3)
            h.end = round(base + t_end * 1000, 3)
            self.timing.end_timing_at(h)

    def _module_fetched(self, m, agreed: dict) -> dict:
        """The fetched keys that module m's host_update reads."""
        return {k: agreed[k] for k in m.host_fetch_keys() if k in agreed}

    def _host_view(self, frame_np, fetched: dict):
        """The frame and fetched dict that the host modules see."""
        return frame_np, fetched

    def _host_post_frame(self, frame_id, frame_np, fetched, host_params, agreed):
        """The host step of a drained frame: the modules' host updates from
        `agreed` (``_agree``'s data), then the host modules."""
        for m in self.pipeline.modules:
            updated = m.host_update(self.pipeline.ctx, frame_id,
                                    self._module_fetched(m, agreed), system=self)
            if updated:
                host_params[m.name] = {**host_params.get(m.name, {}), **updated}
                self._params_version += 1

        # Host-computed per-run data: merged into the frame's fetched dict
        # (the same object the retention ring holds), so get_run_by_id and
        # later host modules see the keys.
        frame_np, fetched = self._host_view(frame_np, fetched)
        for hm in self.host_modules:
            if not hm.provides_data():
                continue
            try:
                extra = hm.process(self.pipeline.ctx, frame_id, frame_np, fetched,
                                   self.global_data)
            except Exception:
                log.error("host module %s process failed:\n%s", hm.name,
                          traceback.format_exc())
                continue
            if extra:
                fetched.update(extra)

        for hm in self.host_modules:
            try:
                img = hm.render(self.pipeline.ctx, frame_id, frame_np, fetched,
                                self.global_data)
            except Exception:
                log.error("host module %s failed:\n%s", hm.name, traceback.format_exc())
                continue
            if img is None or self.image_sink is None:
                continue
            if isinstance(img, dict):
                for win, im in img.items():
                    self.image_sink.set_image_if_later(win, im, frame_id)
            else:
                self.image_sink.set_image_if_later(hm.name, img, frame_id)
