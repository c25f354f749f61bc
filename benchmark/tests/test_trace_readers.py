"""The readers of the System's own spans and device stamps, on a canned
record; on the card, a short traced run of each cell reports them."""

import json

import pytest

from benchmark import spec
from benchmark.tests.test_command import command
from benchmark.tests.tiny import REPO
from benchmark.tracing import Record, load_reader

STREAM = ["idle_share_unprofiled", "replay_ms", "host_step_ms", "disparity_module_ms",
          "optflow_module_ms"]
CAM = ["dispatch_lag_ms.cam", "fetch_tail_ms.cam"]
BEV = ["fetch_copy_ms.bev"]


def read(name, rec):
    return load_reader(spec.reader_path(REPO, name))(rec)


def canned(rows=None) -> Record:
    """Frames 5 and 6 outside the profile (frame 7 inside it), each with
    its System rows (name, run_id, init, start, end) in epoch ms: frame 5
    dispatched at 100 and fetched at 112, frame 6 at 110 and 121; the
    device busy [101, 109] and [110, 119] (device.frame), idle 1 of 18 ms."""
    if rows is None:
        rows = []
        for fid, t0, replay, host, disp, flow in ((5, 100.0, 0.4, 1.0, 1.5, 2.5),
                                                  (6, 110.0, 0.6, 3.0, 2.5, 3.5),
                                                  (7, 120.0, 9.0, 9.0, 9.0, 9.0)):
            rows += [
                ("frame", fid, t0, t0, t0 + 12 - (fid == 6)),
                ("frame.fetch_copy", fid, t0 + 9.5, t0 + 9.5, t0 + 10 + flow / 2),
                ("frame.replay", fid, t0 + 0.2, t0 + 0.2, t0 + 0.2 + replay),
                ("frame.host_step", fid, t0 + 12, t0 + 12, t0 + 12 + host),
                ("device.frame", fid, t0 + 1 - (fid == 6), t0 + 1 - (fid == 6),
                 t0 + 9),
                ("device.step", fid, t0 + 2, t0 + 2, t0 + 8),
                ("device.ImageOpticalFlow", fid, t0 + 2, t0 + 2, t0 + 2 + flow),
                ("device.ImageDisparity", fid, t0 + 5, t0 + 5, t0 + 5 + disp),
            ]
    return Record(device_events=[], frames=0, wall_s=0.0, timing_rows=rows + [
        ("system", 0, 0.0, 0.0, 500.0), ("system.snapshot", 6, 130.0, 130.0, 140.0)],
                  timing_frames={5, 6}, due_ms={5: 99.0, 6: 108.0}, modules=[], height=0,
                  width=0)


def test_stream_readers():
    rec = canned()
    assert read("idle_share_unprofiled", rec) == pytest.approx(100 * 1 / 18)
    assert read("replay_ms", rec) == pytest.approx(0.5)
    assert read("host_step_ms", rec) == pytest.approx(2.0)
    assert read("disparity_module_ms", rec) == pytest.approx(2.0)
    assert read("optflow_module_ms", rec) == pytest.approx(3.0)


def test_fetch_copy_reader():
    """fetch_copy_ms.bev: the median frame.fetch_copy row of the frames
    before the profiled sub-window (5: 1.75 ms, 6: 2.25 ms; frame 7's 5 ms
    is profiled)."""
    assert read("fetch_copy_ms.bev", canned()) == pytest.approx(2.0)


def test_fetch_copy_reads_a_tiny_traced_run(tiny_root):
    """A traced run of the tiny planes-and-depth cell on the CPU: the
    System's fetch-copy rows are there, and the reader takes a number."""
    import time

    from benchmark import harness

    result = harness.run_cell(tiny_root, "tiny.bev", 20260419, 2.0, True, "cpu",
                              time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["fetch_copy_ms.bev"]["value"] > 0


def test_idle_share_counts_the_gaps_between_frames():
    rows = [("device.frame", 5, 100.0, 100.0, 104.0), ("device.frame", 6, 106.0, 106.0, 110.0),
            ("device.frame", 6, 103.0, 103.0, 105.0)]
    assert read("idle_share_unprofiled", canned(rows)) == pytest.approx(100 * 1 / 10)


def test_fleet_read_reader():
    """read_ms.fleet: the median frame.read row, from the sources' first
    get_next (init) to the round's pinned stack (end), of the rounds before
    the profiled sub-window (5 and 6 here; round 7 is profiled)."""
    rows = [("frame.read", 5, 90.0, 91.0, 94.0), ("frame.read", 6, 100.0, 100.5, 106.0),
            ("frame.read", 7, 110.0, 110.0, 150.0), ("frame.replay", 5, 95.0, 95.0, 99.0)]
    assert read("read_ms.fleet", canned(rows)) == pytest.approx(5.0)
    assert read("read_ms.fleet", canned([r for r in rows if r[1] == 7])) is None


def test_flow_median_reader_takes_either_kernel():
    """flow_median_ms: the device ms a frame of the flow's medians, by the
    hand-written kernel's name or PyTorch's median kernel's, and nothing
    else."""
    events = [("void median3x3_kernel<2>(float const*, float*, int, int)", 0.0, 6.0),
              ("void median3x3_kernel<1>(float const*, float*, int, int)", 10.0, 12.0),
              ("void at::native::(anonymous namespace)::gatherMedian<float>(...)", 20.0, 30.0),
              ("void sgm_wta_kernel(unsigned char const*)", 30.0, 1030.0)]
    rec = canned()
    rec.device_events, rec.frames = events, 2
    assert read("flow_median_ms", rec) == pytest.approx((6.0 + 2.0 + 10.0) / 1e3 / 2)
    rec.device_events = events[:2]
    assert read("flow_median_ms", rec) == pytest.approx(8.0 / 1e3 / 2)
    rec.device_events = events[3:]
    assert read("flow_median_ms", rec) is None


def test_camera_readers():
    rec = canned()
    # Frame 5: dispatched 100, step on the device at 102, copies out done at
    # 109, fetched at 112; frame 6: 110, 112, 119, 121.
    assert read("dispatch_lag_ms.cam", rec) == pytest.approx(2.0)
    assert read("fetch_tail_ms.cam", rec) == pytest.approx(2.5)


@pytest.mark.parametrize("name", STREAM + CAM + BEV)
def test_readers_find_nothing_without_rows(name):
    assert read(name, canned([])) is None


@pytest.mark.parametrize("name", STREAM + CAM + BEV)
def test_readers_find_nothing_outside_the_unprofiled_frames(name):
    """The profiled frame's rows alone (frame 7): nothing to read."""
    rows = [r for r in canned().timing_rows if r[1] == 7]
    assert read(name, canned(rows)) is None


def test_host_spans_alone_give_no_camera_metric():
    """A CPU run has host spans and no device rows: the camera's readers
    take only device rows against the frame row."""
    rows = [r for r in canned().timing_rows if not r[0].startswith("device.")]
    assert read("dispatch_lag_ms.cam", canned(rows)) is None
    assert read("fetch_tail_ms.cam", canned(rows)) is None


@pytest.mark.card
@pytest.mark.parametrize("workload,names", [("kitti-planeseg.stream", STREAM),
                                            ("zed-planeseg.cam60", CAM),
                                            ("kitti-planeseg.bev", STREAM + BEV)])
def test_a_short_traced_run_reports_the_span_metrics(card, workload, names):
    out = command(REPO, workload, 2**31 + 29, 4, trace=1)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert set(names) <= set(result["metrics"])
    for name in names:
        assert result["metrics"][name]["value"] >= 0, name
