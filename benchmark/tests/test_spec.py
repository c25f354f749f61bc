"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

import copy
import json
import shutil
from pathlib import Path

import pytest

from benchmark import spec
from benchmark.tracing import load_reader

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def bench():
    return spec.load(REPO)


def test_committed_spec_is_valid(bench):
    spec.validate(bench, REPO)


def test_names_units_and_moves(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert spec.NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert spec.UNIT.match(m["unit"]), m["unit"]
    for w in bench["workloads"]:
        reported = {m["name"] for m in spec.end_to_end_of(bench, w["name"])}
        for m in spec.per_layer_of(bench, w["name"]):
            assert m["moves"] in reported, (w["name"], m["name"])


def test_the_cells_and_metrics(bench):
    assert {w["name"] for w in bench["workloads"]} == {"kitti-planeseg.stream",
                                                        "zed-planeseg.cam60"}
    # latency_p95_ms was measured and left out: its runs spread too widely
    # for the widest bound (PERF.md).
    assert {m["name"] for m in bench["end_to_end"]} == {"fps", "latency_p50_ms", "setup_s"}
    assert {m["name"] for m in bench["per_layer"]} == {
        "device_idle_share", "device_ops_per_frame", "flow_median_ms", "sgm_roofline",
        "frame_span_ms.cam", "device_busy_ms.cam", "queue_wait_ms.cam"}


@pytest.mark.parametrize("breakage", [
    ("end_to_end", 0, "bound", 0.3),
    ("end_to_end", 0, "unit", "frames per second"),
    ("per_layer", 0, "moves", "latency_p50_ms"),
    ("per_layer", 0, "why", "a key the contract does not have"),
    ("workloads", 0, "chips", 2),
    ("workloads", 1, "traffic", "no_such_mix"),
    ("configs", 0, "reduced", ["hidden_size"]),
])
def test_a_broken_spec_is_refused(bench, breakage):
    group, i, key, value = breakage
    broken = copy.deepcopy(bench)
    broken[group][i][key] = value
    with pytest.raises(spec.SpecError):
        spec.validate(broken, REPO)


def test_setup_s_is_required(bench):
    broken = copy.deepcopy(bench)
    broken["end_to_end"] = [m for m in broken["end_to_end"] if m["name"] != "setup_s"]
    with pytest.raises(spec.SpecError):
        spec.validate(broken, REPO)


def test_files_added_are_found_by_name(tmp_path, bench):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries in a copy of the benchmark are found by their names."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "kitti-planeseg.json").read_text())
    cfg["name"] = "kitti-w1241"
    cfg["geometry"]["width"] = 1241
    (b / "configs" / "kitti-w1241.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "stream.json").read_text())
    mix["max_in_flight"] = 2
    (b / "traffic" / "stream2.json").write_text(json.dumps(mix))
    (b / "layer_metrics" / "frames_traced.py").write_text(
        "def read(rec):\n    return float(rec.frames) if rec.frames else None\n")
    new = copy.deepcopy(bench)
    new["configs"].append({"name": "kitti-w1241", "source": "KITTI odometry 00-02",
                           "file": "benchmark/configs/kitti-w1241.json", "reduced": [],
                           "why": "the real KITTI width"})
    new["workloads"].append({"name": "kitti-w1241.stream2", "config": "kitti-w1241",
                             "traffic": "stream2", "chips": 1, "why": "two in flight"})
    new["end_to_end"][0]["workloads"].append("kitti-w1241.stream2")
    new["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                             "source": "device_trace", "layer": "device", "moves": "fps",
                             "workloads": ["kitti-w1241.stream2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    loaded = spec.load(tmp_path)
    spec.validate(loaded, tmp_path)
    cell = spec.cell(loaded, "kitti-w1241.stream2")
    assert spec.load_config(tmp_path, loaded, cell["config"])["geometry"]["width"] == 1241
    assert spec.load_traffic(tmp_path, cell["traffic"])["max_in_flight"] == 2
    names = [m["name"] for m in spec.per_layer_of(loaded, "kitti-w1241.stream2")]
    assert names == ["frames_traced"]
    read = load_reader(spec.reader_path(tmp_path, "frames_traced"))
    assert read(type("R", (), {"frames": 7})()) == 7.0
