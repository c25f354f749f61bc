"""The command: refuses to run without a card, and in a directory that
holds only BENCHMARK.json and the benchmark's files; on a card (marked
tests) each cell's short run is correct and reports its metrics."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.tiny import REPO


def command(cwd, workload, seed, seconds, trace=0, timeout=900):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", str(seed), "--seconds", str(seconds), "--trace",
                           str(trace)], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    run fails (no card here, or no program on one) and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path, "kitti-planeseg.stream", 1, 1, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_card_no_result():
    """Without a CUDA device the command exits with another code than 0
    and prints nothing on standard output (it never falls back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = command(REPO, "kitti-planeseg.stream", 1, 1, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load(REPO)["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, workload, trace):
    out = command(REPO, workload, 2**31 + 11, 4, trace)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    bench = spec.load(REPO)
    of = spec.per_layer_of if trace else spec.end_to_end_of
    assert set(result["metrics"]) == {m["name"] for m in of(bench, workload)}
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.card
@pytest.mark.parametrize("workload,frames", [("kitti-planeseg.stream", 300),
                                             ("zed-planeseg.cam60", 300)])
def test_the_control_fails_at_the_cells_size(card, workload, frames):
    from benchmark import compare
    from benchmark.control import control_readings

    readings = control_readings(REPO, workload, seed=3, frames=frames, device="cuda")
    assert not compare.correct(readings), readings
