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
    """The contract, not a list of names: every declared per-layer metric has
    a reader under benchmark/layer_metrics/ with a ``read``, and every
    reader there is declared; every metric's cells exist and every metric
    is reported in some cell; every end-to-end metric is one the harness's
    core computes for the loop of each cell that reports it; every cell
    reports setup_s, another end-to-end metric and a per-layer metric."""
    readers = {p.name.removesuffix(".py")
               for p in (REPO / "benchmark" / "layer_metrics").glob("*.py")}
    declared = {m["name"] for m in bench["per_layer"]}
    assert readers == declared
    for name in declared:
        assert callable(load_reader(spec.reader_path(REPO, name))), name
    cells = {w["name"] for w in bench["workloads"]}
    reported_somewhere = set()
    for w in bench["workloads"]:
        loop = spec.load_traffic(REPO, w["traffic"])["loop"]
        e2e = {m["name"] for m in spec.end_to_end_of(bench, w["name"])}
        layer = {m["name"] for m in spec.per_layer_of(bench, w["name"])}
        assert "setup_s" in e2e and e2e - {"setup_s"}, w["name"]
        assert e2e <= spec.E2E_BY_LOOP[loop], w["name"]
        assert layer, w["name"]
        reported_somewhere |= e2e | layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    assert reported_somewhere == {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}


def test_the_bev_cell(bench):
    """kitti-planeseg.bev: the stream's scene and loop, fetching planes and
    depth, reporting fps and setup_s, and traced, the fetch copy's span
    beside the stream's metrics of the captured single-sequence step (its
    launch, host step, module stamps, kernels and the device); every
    metric it reports has its reader."""
    cell = spec.cell(bench, "kitti-planeseg.bev")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("kitti-planeseg", "bev", 1)
    bev, stream = spec.load_traffic(REPO, "bev"), spec.load_traffic(REPO, "stream")
    assert bev["fetch"] == ["planes", "depth"]
    assert (bev["loop"], bev["streams"], bev["max_in_flight"], bev["frame_cycle"]) == \
        ("closed", 1, 4, 64)
    assert bev["scene"] == stream["scene"]
    assert bev["trace"] == {"after_frames": 64, "frames": 200}
    assert {m["name"] for m in spec.end_to_end_of(bench, cell["name"])} == {"fps", "setup_s"}
    layer = {m["name"] for m in spec.per_layer_of(bench, cell["name"])}
    assert layer == {"device_idle_share", "device_ops_per_frame", "idle_share_unprofiled",
                     "fetch_copy_ms.bev", "replay_ms", "host_step_ms", "disparity_module_ms",
                     "optflow_module_ms", "sgm_roofline", "flow_median_ms"}
    for name in layer:
        assert callable(load_reader(spec.reader_path(REPO, name))), name


@pytest.mark.parametrize("reference", [None, "benchmark/reference/none.py",
                                       "benchmark/../benchmark/reference/chain.py",
                                       "cartslam_tpu_torch/config/registry.py"])
def test_a_configuration_names_its_reference_module(tmp_path, bench, reference):
    """Each configuration's ``reference`` names a .py file under paths; one
    that is missing, absent, leaves the checkout's paths or lies outside
    them fails validation."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "benchmark" / "configs" / "kitti-planeseg.json"
    cfg = json.loads(path.read_text())
    spec.validate(bench, tmp_path)
    if reference is None:
        del cfg["reference"]
    else:
        cfg["reference"] = reference
    path.write_text(json.dumps(cfg))
    with pytest.raises(spec.SpecError, match="reference"):
        spec.validate(bench, tmp_path)


@pytest.mark.parametrize("mix,streams", [("cam60", 2), ("fleet8", 0), ("fleet8", 1.5),
                                         ("fleet8", "8"), ("fleet8", True)])
def test_a_broken_stream_count_is_refused(tmp_path, bench, mix, streams):
    """Several streams in an open loop, or a stream count that is not a
    whole number >= 1, fail validation."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = spec.traffic_path(tmp_path, mix)
    traffic = json.loads(path.read_text())
    traffic["streams"] = streams
    path.write_text(json.dumps(traffic))
    with pytest.raises(spec.SpecError, match="streams"):
        spec.validate(bench, tmp_path)


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
