"""A tiny copy of the benchmark for CPU tests: the committed benchmark files
plus two cells at 64x160 with 32 disparities, short superpixel segments,
frequent provider updates and snapshots, so that a run of a few seconds on the CPU passes through
every step variant, the provider's updates and the snapshot drains."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

MODULES = [
    {"type": "superpixels", "initial_iterations": 4, "iterations": 2, "block_size": 12,
     "reset_iterations": 8},
    {"type": "optflow"},
    {"type": "disparity", "num_disparities": 32, "min_disparity": 1, "smoothing_radius": 2,
     "smoothing_iterations": 1},
    {"type": "disparity_derivative"},
    {"type": "depth"},
    {"type": "superpixel_disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
     "use_temporal_smoothing": True, "update_interval": 5, "reset_interval": 3},
]
# Disparities inside the smoothing's validity bound (width / 16 px), so the
# histogram has peaks and the planes more than one class.
SCENE = {"fx": 100.0, "baseline": 0.4, "max_disparity": 10.0, "pan_px": 2}


def make_root(dest: Path) -> Path:
    """A checkout-like directory at dest: BENCHMARK.json and benchmark/ as
    committed, plus the tiny configuration, two tiny mixes and their cells."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = dest / "benchmark"
    (b / "configs" / "tiny.json").write_text(json.dumps({
        "name": "tiny", "geometry": {"height": 64, "width": 160}, "modules": MODULES,
        "system": {"snapshot_interval": 16}}))
    (b / "traffic" / "tiny_stream.json").write_text(json.dumps({
        "loop": "closed", "max_in_flight": 4, "fetch": ["planes"], "frame_cycle": 8,
        "scene": SCENE, "trace": {"after_frames": 4, "frames": 6}}))
    (b / "traffic" / "tiny_cam.json").write_text(json.dumps({
        "loop": "open", "rate_fps": 30, "max_in_flight": 1, "fetch": ["planes"],
        "frame_cycle": 8, "scene": SCENE, "trace": {"frames": 6, "before_end_frames": 3}}))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "tests", "file":
                            "benchmark/configs/tiny.json", "reduced": [], "why": "tests"})
    spec["workloads"] += [
        {"name": "tiny.stream", "config": "tiny", "traffic": "tiny_stream", "chips": 1,
         "why": "tests"},
        {"name": "tiny.cam", "config": "tiny", "traffic": "tiny_cam", "chips": 1,
         "why": "tests"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            for real, tiny in (("kitti-planeseg.stream", "tiny.stream"),
                               ("zed-planeseg.cam60", "tiny.cam")):
                if real in m["workloads"]:
                    m["workloads"].append(tiny)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest
