"""The System's spans, device stamps and counters, on the CPU.

A System given a TimingWriter (and no module timing) traces: one row a
host span a frame, on the writer's clock, and a host range a span while a
profiler runs; without a writer it writes only the rows it
always wrote and opens no range.  The device stamp's plain version, the
stamps of the captured step's body, the clock fit and the stamps' rows are
held on the CPU with a fake clock.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.kernels import stamp as kstamp
from cartslam_tpu_torch.runtime import graphs
from cartslam_tpu_torch.runtime import timing
from cartslam_tpu_torch.runtime.timing import ClockFit, TimingWriter

SOURCE = {"type": "synthetic", "image_size": [32, 64], "num_frames": 4}
MODULES = [{"type": "disparity", "num_disparities": 16, "min_disparity": 1},
           {"type": "disparity_derivative"}]
KEYS = ["disparity", "disparity_derivative"]
FRAMES = SOURCE["num_frames"]
# The host spans of every frame of a traced eager run, in their order.
HOST_SPANS = ["frame.read", "frame.handoff", "frame.upload", "frame.step", "frame.stage"]
DRAIN_SPANS = ["frame.join", "frame.fetch_wait", "frame.fetch_copy", "frame.host_step",
               "frame.deliver"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: a pool's spinning threads take the cores the
    System's own threads need (a 4-frame run takes seconds, not 0.1 s)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Recorder(TimingWriter):
    """Keeps every row in memory: (name, run_id, init, start, end)."""

    def __init__(self):
        super().__init__(enabled=False)
        self.rows = []

    def end_timing_at(self, handle):
        self.rows.append((handle.name, handle.run_id, handle.init, handle.start, handle.end))


def _run(timing=None, **kw):
    seen = {}
    system = build_system(SOURCE, MODULES, device="cpu", timing=timing, extra_fetch_keys=KEYS,
                          snapshot_interval=2, **kw)
    assert system.run(on_frame=lambda fid, out: seen.update({fid: out})) == FRAMES
    return system, seen


def test_traced_system_writes_each_span_once_a_frame_in_order():
    rec = Recorder()
    t0 = time.time() * 1000
    system, _ = _run(rec)
    t1 = time.time() * 1000
    assert system.tracing
    for fid in range(1, FRAMES + 1):
        rows = {r[0]: r[2:] for r in rec.rows if r[1] == fid and r[0] != "system.snapshot"}
        names = [r[0] for r in rec.rows if r[1] == fid and r[0] != "system.snapshot"]
        assert sorted(names) == sorted(["frame", *HOST_SPANS, *DRAIN_SPANS]), fid
        for name, (init, start, end) in rows.items():
            assert t0 <= init <= start <= end <= t1, (fid, name)
        for before, after in zip(HOST_SPANS, HOST_SPANS[1:]):
            assert rows[before][2] <= rows[after][1], (fid, before, after)
        # The frame row runs from its dispatch to the fetch's end, which also
        # ends the fetch's copy; the host step follows the join.
        assert rows["frame"][1] <= rows["frame.upload"][1]
        assert rows["frame"][2] == rows["frame.fetch_copy"][2]
        assert rows["frame.join"][2] <= rows["frame.host_step"][1]
    # A snapshot every 2 frames, each a drain and a host copy.
    assert [r[1] for r in rec.rows if r[0] == "system.snapshot"] == [2, 4]
    assert not any(r[0].startswith("device.") for r in rec.rows)  # the eager path


def _count_ranges(monkeypatch):
    made = []
    real = timing.host_range

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(timing, "host_range", counting)
    return made


@pytest.mark.parametrize("traced", [False, True])
def test_ranges_only_in_a_traced_system_under_a_profiler(monkeypatch, traced):
    """Under a running profiler a traced System opens a `cart.` range a
    main-thread span; one given no writer writes only its frame and system
    rows and opens none."""
    names = []
    end_at = TimingWriter.end_timing_at

    def seen(self, handle):
        names.append(handle.name)
        end_at(self, handle)

    monkeypatch.setattr(TimingWriter, "end_timing_at", seen)
    made = _count_ranges(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        system, _ = _run(Recorder() if traced else None)
    assert system.tracing == traced
    profiled = [e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("cart.")]
    assert sorted(profiled) == sorted(made)
    if traced:
        assert {"cart.frame.upload", "cart.frame.step", "cart.frame.stage", "cart.frame.join",
                "cart.frame.deliver", "cart.system.snapshot"} <= set(made)
        assert made.count("cart.frame.step") == FRAMES
    else:
        assert made == []
        assert sorted(names) == ["frame"] * FRAMES + ["system"]


def test_a_traced_system_opens_no_range_without_a_profiler(monkeypatch):
    made = _count_ranges(monkeypatch)
    _run(Recorder())
    assert made == []


def test_module_timing_rows_are_unchanged():
    rec = Recorder()
    system, _ = _run(rec, module_timing=True)
    assert not system.tracing
    names = [r[0] for r in rec.rows]
    assert sorted(set(names)) == ["ImageDisparity", "ImageDisparityDerivative", "frame", "system"]
    assert names.count("frame") == names.count("ImageDisparity") == FRAMES


@pytest.mark.parametrize("traced", [False, True])
def test_counters_match_the_fetched_bytes(traced):
    system, seen = _run(Recorder() if traced else None)
    assert sorted(seen) == list(range(1, FRAMES + 1))
    assert system.counters == {
        "fetched_bytes": sum(a.nbytes for out in seen.values() for a in out.values()),
        "fetch_threads": FRAMES, "captures": 0, "pinned_host_allocs": 0}
    assert system.counters["fetched_bytes"] == FRAMES * 32 * 64 * (2 + 4)


def test_the_stamps_plain_version_writes_the_host_clock():
    row = torch.zeros(3, dtype=torch.int64)
    calls = kstamp.COUNTER.plain_calls
    before = time.time_ns()
    kstamp.stamp(row, 1)
    assert before <= int(row[1]) <= time.time_ns()
    assert row[0] == row[2] == 0 and kstamp.COUNTER.plain_calls == calls + 1
    kstamp.stamp_plain(row, 2, clock=lambda: 42)
    assert int(row[2]) == 42
    with pytest.raises(IndexError):
        kstamp.stamp(row, 3)


def test_fit_clock_keeps_the_shortest_round_against_a_fake_clock():
    """Each round reads the host clock, stamps the device clock (the host's
    less OFFSET), reads the host clock: steps of (before the stamp, after
    it) ns.  Only round 2, the shortest, has its stamp at its midpoint."""
    offset = 987_654_321
    steps = [(100, 9000), (4000, 1000), (150, 150), (3000, 30)]
    ticks, t = [], 10**15
    for a, b in steps:
        for step in (1000, a, b):
            t += step
            ticks.append(t)
    clock = iter(ticks)
    host = clock.__next__
    row = torch.zeros(len(steps), dtype=torch.int64)
    fit = timing.fit_clock(lambda i: kstamp.stamp_plain(row, i, clock=lambda: host() - offset),
                           lambda: None, row.tolist, rounds=len(steps), clock=host)
    assert fit == ClockFit(offset, 150)
    assert fit.to_ms(10**15 - offset) == 10**9
    assert next(clock, None) is None  # every tick read


def test_the_captured_body_stamps_the_step_and_each_module():
    """The step body of a stamped StaticBuffers (run eagerly on the CPU, as
    a capture records it) stamps its start and each module's end, and the
    row's spans follow the modules."""
    system = build_system(SOURCE, MODULES, device="cpu")
    pipe = system.pipeline
    frame = system.source.get_next()
    bufs = graphs.StaticBuffers(pipe, frame)
    bufs.load_frame({k: torch.from_numpy(v) for k, v in frame.items()
                     if isinstance(v, np.ndarray)}, 1)
    n = len(pipe.modules)
    bufs.add_stamps(n)
    row = bufs.stamps
    bufs.add_stamps(n)
    assert bufs.stamps is row and len(row.row) == n + 3  # one row for every variant's graph
    calls = kstamp.COUNTER.plain_calls
    graphs._sequence_body(pipe, bufs, bufs.state, bufs.frame, pipe.variant(1), frozenset(KEYS))
    assert kstamp.COUNTER.plain_calls == calls + n + 1
    stamps = row.row.tolist()
    assert stamps[0] == stamps[-1] == 0  # the System's own, outside the step
    body = stamps[1:-1]
    assert all(a > 0 for a in body) and body == sorted(body)
    row.frame_in()
    row.frame_out()
    assert stamps[1:-1] == row.row.tolist()[1:-1] and row.row[0] <= row.row[-1]
    stamps[0], stamps[-1] = body[0] - 10**6, body[-1] + 2 * 10**6
    spans = timing.StampRow.spans(stamps, ClockFit(0, 0), [m.name for m in pipe.modules])
    assert list(spans) == ["device.frame", "device.step", "device.ImageDisparity",
                           "device.ImageDisparityDerivative"]
    assert spans["device.frame"][2] - spans["device.frame"][1] == pytest.approx(
        (body[-1] - body[0]) / 1e6 + 3, abs=1e-3)
    assert spans["device.step"][1:] == (spans["device.ImageDisparity"][1],
                                        spans["device.ImageDisparityDerivative"][2])


def test_a_batched_step_takes_no_stamps():
    system = build_system(SOURCE, MODULES, device="cpu")
    bufs = graphs.StaticBuffers(system.pipeline, system.source.get_next(), batch=2)
    with pytest.raises(ValueError, match="no stamps"):
        bufs.add_stamps(5)
