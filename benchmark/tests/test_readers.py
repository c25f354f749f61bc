"""Each per-layer reader on a canned record."""

import pytest

from benchmark import spec
from benchmark.roofline import peaks, sgm
from benchmark.tracing import Record, breakdown, load_reader, short_name, union_us
from benchmark.tests.tiny import REPO

MODULES = [{"type": "disparity", "num_disparities": 256}]


def read(name, rec):
    return load_reader(spec.reader_path(REPO, name))(rec)


def canned(**kw) -> Record:
    """Two frames in a 10 ms sub-window: device busy [0, 2] and [3, 6] ms
    (union 5 ms) in 5 operations, of which a median kernel of 1 ms and K1's
    kernels 0.5 + 1.5 ms; frame rows 5 and 6 outside the profile."""
    events = [
        ("void at::native::(anonymous namespace)::gatherMedian<float>(...)", 0.0, 1000.0),
        ("void sgm_hpaths_kernel<unsigned char, 8, false>(int const*)", 1000.0, 1500.0),
        ("Memcpy DtoH (Device -> Pinned)", 1200.0, 2000.0),
        ("void sgm_wta_kernel(unsigned char const*)", 3000.0, 4500.0),
        ("void sgm_vpaths_acc_kernel<2>(int const*)", 4500.0, 6000.0),
    ]
    base = dict(device_events=events, frames=2, wall_s=0.010,
                timing_rows=[("frame", 5, 0.0, 100.0, 112.0), ("frame", 6, 0.0, 120.0, 130.0),
                             ("frame", 7, 0.0, 140.0, 190.0), ("system", 0, 0.0, 0.0, 500.0)],
                timing_frames={5, 6}, due_ms={5: 99.0, 6: 117.0},
                modules=MODULES, height=376, width=1248)
    base.update(kw)
    return Record(**base)


def test_union():
    assert union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert union_us([]) == 0


def test_device_readers():
    rec = canned()
    assert read("device_idle_share", rec) == pytest.approx(100 * (1 - 0.005 / 0.010))
    assert read("device_busy_ms.cam", rec) == pytest.approx(2.5)
    assert read("device_ops_per_frame", rec) == pytest.approx(2.5)
    assert read("flow_median_ms", rec) == pytest.approx(0.5)


def test_sgm_roofline_counts_k1_only():
    rec = canned()
    k1_s = (0.5e-3 + 1.5e-3) / 2  # hpaths + wta; the accumulating K6 kernel is not K1
    bound, by = peaks.bound_s(*sgm.work(376, 1248, 256))
    assert by == "operations"
    assert bound * 1e3 == pytest.approx(0.0753, abs=1e-4)  # the bound of PERF.md's K1 row
    assert read("sgm_roofline", rec) == pytest.approx(100 * bound / k1_s)


def test_span_readers():
    rec = canned()
    assert read("frame_span_ms.cam", rec) == pytest.approx(11.0)
    assert read("queue_wait_ms.cam", rec) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["device_idle_share", "device_ops_per_frame", "flow_median_ms",
                                  "sgm_roofline", "device_busy_ms.cam"])
def test_device_readers_find_nothing_in_an_empty_trace(name):
    assert read(name, canned(device_events=[])) is None


@pytest.mark.parametrize("name", ["frame_span_ms.cam", "queue_wait_ms.cam"])
def test_span_readers_find_nothing_without_rows(name):
    assert read(name, canned(timing_rows=[])) is None


def test_breakdown():
    rec = canned()
    host = [("cudaGraphLaunch", 2000.0, 2900.0), ("aten::copy_", 0.0, 6000.0)]
    got = breakdown(rec.device_events, host)
    names = [k for k, _ in got["device_ops"]]
    assert names[0] == "sgm_wta_kernel"
    assert short_name(rec.device_events[1][0]) == "sgm_hpaths_kernel<unsigned char, 8, false>"
    # The one gap, [2, 3] ms, overlaps the graph launch for 0.9 ms and the
    # copy for 1 ms: the copy wins.
    assert got["idle_gaps"] == [["aten::copy_", pytest.approx(0.001)]]
