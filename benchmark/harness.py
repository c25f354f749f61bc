"""One run of one cell: set-up, the measured window, the traced readings and
the check against the reference.

The program under test is ``cartslam_tpu_torch``: the harness builds its
System through the public entry ``config.build_system`` with a DataSource
of its own (the cell's frames, rendered from the seed), the traffic's
frames in flight and fetch keys, and, in a traced run, a TimingWriter that
keeps the System's frame rows in memory.  The System's ``run`` drives every
frame; the harness stamps each frame's delivery in ``on_frame``.

Set-up runs frames 1..warm, where warm is the first frame after which no
new step variant appears (the flagship's 'reset' frame, 64), so every
variant's CUDA graph is captured before the window.  The window starts at
frame warm's delivery:

  closed loop: the source yields frames as fast as the System takes them;
      fps = frames delivered in the window / its seconds.
  open loop:   frame warm + k is due at t0 + k / rate, released then whether
      or not the System kept up; the latency of each frame due in the
      window runs from its due time to its delivery, a frame that never
      comes counts as failed.

setup_s runs from the start of the process to the window's start.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from . import compare, spec
from .data.synthetic import SyntheticScene
from .tracing import Record, breakdown, busy_s, load_reader, profile_events

# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = {"jax", "jaxlib", "flax", "cartslam_tpu"}


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def warm_frames(variant, horizon: int = 10_000) -> int:
    """The last frame id that brings a step variant not seen before."""
    seen, last = set(), 1
    for fid in range(1, horizon):
        v = variant(fid)
        if v not in seen:
            seen.add(v)
            last = fid
    return last


def _make_source(base, frames, q, traffic: dict, seconds: float):
    """The cell's DataSource (a subclass of the program's base class, made
    once the program is imported); its ``warm`` is set before the run."""

    class StreamSource(base):
        """Cycles through the rendered frames.  Closed loop: yields until
        stopped.  Open loop: frames after warm are released at their due
        times, t0 + (fid - warm) / rate, and the source ends after the
        window's last due frame."""

        def __init__(self):
            super().__init__(image_size=frames[0][0].shape[:2])
            self.intrinsics.q = q
            self.rate = traffic.get("rate_fps")
            self.warm = 0
            self.next_id = 1
            self.stop = threading.Event()
            self.armed = threading.Event()
            self.t0 = 0.0
            self.due: dict[int, float] = {}

        def arm(self, t0: float) -> None:
            self.t0 = t0
            self.armed.set()

        def is_next_ready(self) -> bool:
            return not self.is_finished()

        @property
        def count(self) -> int | None:
            """Frames the open loop yields: warm-up, then the window's."""
            return self.warm + round(self.rate * seconds) if self.rate else None

        def is_finished(self) -> bool:
            return self.stop.is_set() or (self.count is not None and self.next_id > self.count)

        def get_next(self):
            fid = self.next_id
            if self.rate and fid > self.warm:
                while not self.armed.wait(0.1):
                    if self.stop.is_set():
                        return None
                due = self.t0 + (fid - self.warm) / self.rate
                self.due[fid] = due
                delay = due - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
            self.next_id += 1
            left, right = frames[(fid - 1) % len(frames)]
            return {"left": left, "right": right}

    return StreamSource()


def _timing_writer(base):
    class MemoryTiming(base):
        """The System's timing rows kept in memory, not written to a file."""

        def __init__(self):
            super().__init__(enabled=False)
            self.rows: list[tuple] = []

        def end_timing_at(self, handle):
            self.rows.append((handle.name, handle.run_id, handle.init, handle.start, handle.end))

    return MemoryTiming()


def card_readings() -> dict:
    """The card's power limit and SM clocks (MHz, now and at most) from
    nvidia-smi; empty where they cannot be read."""
    keys = ("power.limit", "clocks.sm", "clocks.max.sm")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(keys)}",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
        return dict(zip(keys, (float(v) for v in out.stdout.strip().split(","))))
    except (OSError, subprocess.SubprocessError, ValueError):
        return {}


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _log_spread(log, source, stamp: dict, window_ids, ws: float, seconds: float) -> None:
    """How the window's numbers spread, for the run's log: the latency's
    tail (open loop) or the delivery intervals (closed loop), and both by
    fifths of the window."""
    fifths: list[list] = [[] for _ in range(5)]
    if source.rate:
        lat = {f: (stamp[f] - source.due[f]) * 1e3 for f in window_ids if f in stamp}
        if not lat:
            return
        for f, x in lat.items():
            fifths[min(4, int((source.due[f] - ws) / seconds * 5))].append(x)
        v = list(lat.values())
        log(f"window: latency ms p90 {_percentile(v, 90):.3f}, p99 {_percentile(v, 99):.3f}, "
            f"max {max(v):.3f}; {sum(x > 1e3 / source.rate for x in v)} frames over one "
            "frame interval; by fifths p50/p95 " + " ".join(
                f"{_percentile(f, 50):.2f}/{_percentile(f, 95):.2f}" for f in fifths if f))
    elif len(window_ids) > 1:
        gaps = np.diff(sorted(stamp[f] for f in window_ids)) * 1e3
        for f in window_ids:
            fifths[min(4, int((stamp[f] - ws) / seconds * 5))].append(f)
        log("window: delivery intervals ms "
            + ", ".join(f"p{q} {np.percentile(gaps, q):.3f}" for q in (50, 90, 99, 100))
            + "; frames/s by fifths " + " ".join(f"{len(f) * 5 / seconds:.1f}" for f in fifths))


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log=lambda msg: None, patch=None) -> dict:
    """One run: returns the result line's object (keys correct, attempted,
    failed, metrics, device, breakdown in a traced run, checks last).
    t_start: perf_counter at the start of the process.  patch(), where
    given, runs once the program is imported (the tests plant faults with
    it)."""
    bench = spec.load(root)
    spec.validate(bench, root)
    cell = spec.cell(bench, workload)
    config = spec.load_config(root, bench, cell["config"])
    traffic = spec.load_traffic(root, cell["traffic"])
    e2e = [m["name"] for m in spec.end_to_end_of(bench, workload)]
    layer = [m["name"] for m in spec.per_layer_of(bench, workload)]
    dev = torch.device(device)

    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.runtime.timing import TimingWriter
    from cartslam_tpu_torch.sources.base import DataSource

    if patch is not None:
        patch()
    geometry = config["geometry"]
    scene = SyntheticScene((geometry["height"], geometry["width"]), seed, **traffic["scene"])
    frames = scene.cycle(traffic["frame_cycle"], device=dev)
    max_in_flight = traffic["max_in_flight"]
    snapshot_interval = config["system"]["snapshot_interval"]
    writer = _timing_writer(TimingWriter) if trace else None
    source = _make_source(DataSource, frames, scene.q, traffic, seconds)
    system = build_system(source, config["modules"], device=device,
                          max_in_flight=max_in_flight, extra_fetch_keys=traffic["fetch"],
                          timing=writer, snapshot_interval=snapshot_interval)
    warm = source.warm = warm_frames(system.pipeline.variant)
    log(f"set-up: {len(frames)} frames of {geometry['height']}x{geometry['width']} rendered, "
        f"System built ({'captured' if system.captured else 'eager'}), warm-up frames 1..{warm}")

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=activities):  # the profiler's own start-up, before the window
            torch.zeros(1, device=dev).add_(1)
        prof = profile(activities=activities)
    # The profiled sub-window: in a closed loop `after_frames` into the
    # window; in an open loop it ends `before_end_frames` before the
    # window's last due frame, so that the profiler's start and stop, which
    # hold the host, delay no frame whose span the readers take.
    t_trace = traffic.get("trace", {})
    if source.rate:
        p_last = source.count - t_trace.get("before_end_frames", 30)
        p_first = p_last - t_trace.get("frames", 100)
    else:
        p_first = warm + t_trace.get("after_frames", 64)
        p_last = p_first + t_trace.get("frames", 100)

    delivered: dict[int, dict] = {}
    stamp: dict[int, float] = {}
    window: dict[str, float] = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def on_frame(fid, fetched):
        now = time.perf_counter()
        delivered[fid] = fetched
        stamp[fid] = now
        if fid == warm:
            window["start"] = now
            window["end"] = now + seconds
            source.arm(now)
        elif "end" in window and now >= window["end"] and not source.rate:
            source.stop.set()
        if prof is not None and fid == p_first:
            sync()
            prof.start()
            window["trace_start"] = time.perf_counter()
        elif prof is not None and fid == p_last and "trace_start" in window:
            sync()
            window["trace_s"] = time.perf_counter() - window["trace_start"]
            prof.stop()

    try:
        system.run(on_frame)
    finally:
        source.stop.set()
    if prof is not None and "trace_s" not in window:
        prof.stop()
        raise RuntimeError("the window ended before the traced sub-window did")
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"modules of JAX or the JAX package are loaded: {found}")

    ws, we = window["start"], window["end"]
    failed_ids = list(system.failed_frames)
    if source.rate:
        due_ids = range(warm + 1, source.count + 1)
        attempted = len(due_ids)
        lat = [(stamp[f] - source.due[f]) * 1e3 for f in due_ids if f in stamp]
        failed = attempted - len(lat)
        measured = {"latency_p50_ms": _percentile(lat, 50) if lat else math.nan,
                    "latency_p95_ms": _percentile(lat, 95) if lat else math.nan}
        window_ids = set(due_ids)
    else:
        window_ids = {f for f, t in stamp.items() if ws < t <= we}
        failed = sum(1 for f in failed_ids if f > warm)
        attempted = len(window_ids) + failed
        measured = {"fps": len(window_ids) / seconds}
    measured["setup_s"] = ws - t_start

    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    card = card_readings() if dev.type == "cuda" else {}
    result_device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "count": cell["chips"], "memory_peak_bytes": int(memory_peak),
                     "power_limit_w": card.get("power.limit")}
    if card:
        log(f"card after the window: {card}")
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    extra = {}
    if trace:
        device_events, host_events = profile_events(prof)
        epoch_ms = (time.time() - time.perf_counter()) * 1e3
        rec = Record(
            device_events=device_events, frames=p_last - p_first, wall_s=window["trace_s"],
            timing_rows=writer.rows, timing_frames={f for f in window_ids if f <= p_first},
            due_ms={f: d * 1e3 + epoch_ms for f, d in source.due.items()},
            modules=config["modules"], height=geometry["height"], width=geometry["width"])
        for name in layer:
            value = load_reader(spec.reader_path(root, name))(rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        busy = busy_s(rec)
        if busy is not None:
            result_device["busy_s"] = busy
        result_device["window_s"] = window["trace_s"]
        extra["breakdown"] = breakdown(device_events, host_events)
        del prof
    else:
        for name in e2e:
            metrics[name] = {"value": measured[name], "unit": units[name]}
    log(f"window: {len(window_ids)} frames, {failed} failed; "
        + ", ".join(f"{k} {v}" for k, v in measured.items()))
    _log_spread(log, source, stamp, window_ids, ws, seconds)

    run = {"delivered": delivered, "failed": failed_ids, "final_state": system.final_state,
           "params": system.global_data.get("plane_parameters")}
    del system, source
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, chain = compare.judge(config["modules"], frames, dev, run, max_in_flight,
                                  snapshot_interval)
    log(f"reference: {len(delivered)} frames compared in {time.perf_counter() - t_ref:.1f} s "
        f"(" + ", ".join(f"{k} {v:.1f} s" for k, v in chain.seconds.items()) + ")")
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"modules of JAX or the JAX package are loaded: {found}")
    return {"correct": compare.correct(checks), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": result_device, **extra,
            "checks": {k: {"value": v, "limit": compare.LIMITS[k]} for k, v in checks.items()}}


def print_result(result: dict) -> None:
    """The check lines last on standard error, the result last on standard
    output."""
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

