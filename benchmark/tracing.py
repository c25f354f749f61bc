"""What a traced run records, and the per-layer readers that reduce it.

A traced run (``--trace 1``) puts a steady sub-window of the measured window
under ``torch.profiler`` (device and host activity), and keeps the System's
own frame spans (its TimingWriter rows) in memory.  ``Record`` holds both,
with the harness's own stamps; each per-layer metric is a reader,
``benchmark/layer_metrics/<name>.py``, whose ``read(record)`` returns a
number, or None where it finds nothing to read (the metric is then left
out of the result line).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Record:
    """The traced sub-window and the System's spans of a run.

    device_events: (name, start_us, end_us) of every device operation the
        profiler saw (kernels, copies, memsets) in the sub-window;
    frames: frames whose device work the sub-window holds;
    wall_s: the sub-window's length on the host clock;
    timing_rows: the System's TimingWriter rows (name, run_id, init_ms,
        start_ms, end_ms), epoch milliseconds;
    timing_frames: frame ids whose rows the readers use (the window's frames
        outside the profiled sub-window);
    due_ms: frame id -> the open-loop generator's due time, epoch ms;
    modules: the configuration's module list; height, width: its geometry.
    """

    device_events: list
    frames: int
    wall_s: float
    timing_rows: list
    timing_frames: set
    due_ms: dict
    modules: list
    height: int
    width: int

    def module(self, mtype: str) -> dict | None:
        return next((m for m in self.modules if m["type"] == mtype), None)

    def frame_rows(self) -> list:
        """The 'frame' rows of the frames the readers use."""
        return [r for r in self.timing_rows if r[0] == "frame" and r[1] in self.timing_frames]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_s(rec: Record) -> float | None:
    if not rec.device_events:
        return None
    return union_us((s, e) for _, s, e in rec.device_events) / 1e6


def load_reader(path: Path):
    """The ``read`` function of a reader file (loaded by path: metric names
    may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_reader_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------- the profile

def profile_events(prof) -> tuple[list, list]:
    """(device events, host events) of a finished profile as (name,
    start_us, end_us): straight from the kineto results where this torch
    has them (building the FunctionEvent tree of a few hundred thousand
    events takes minutes), else from ``prof.events()``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for ev in raw:
            if hasattr(ev, "start_ns"):
                s, d = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
            else:
                s, d = float(ev.start_us()), float(ev.duration_us())
            (device if ev.device_type() == cuda else host).append((ev.name(), s, s + d))
    else:
        for ev in prof.events():
            span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
            (device if ev.device_type == cuda else host).append(span)
    return [e for e in device if e[2] > e[1]], [e for e in host if e[2] > e[1]]


def short_name(name: str) -> str:
    """A kernel's name without 'void ', anonymous namespaces and its
    argument list, at most 120 characters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:120]  # a copy or a memset, named in words
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name[:120]


def breakdown(device: list, host: list, top: int = 10, gaps_scanned: int = 2000) -> dict:
    """The device operations that took most time, and the longest idle gaps
    between them grouped by the host operation that overlaps each gap most
    ('no host op' where none does), in seconds."""
    by_name: dict[str, float] = {}
    for name, s, e in device:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    spans = sorted((s, e) for _, s, e in device)
    gaps, cur_e = [], None
    for s, e in spans:
        if cur_e is not None and s > cur_e:
            gaps.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:gaps_scanned]
    labels: dict[str, float] = {}
    if host:
        names = [h[0] for h in host]
        hs = np.array([h[1] for h in host])
        he = np.array([h[2] for h in host])
        for gs, ge in gaps:
            overlap = np.minimum(he, ge) - np.maximum(hs, gs)
            best = int(np.argmax(overlap - 1e-9 * (he - hs)))
            label = names[best] if overlap[best] > 0 else "no host op"
            labels[label] = labels.get(label, 0.0) + (ge - gs) / 1e6
    else:
        labels = {"no host op": sum(ge - gs for gs, ge in gaps) / 1e6} if gaps else {}
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
