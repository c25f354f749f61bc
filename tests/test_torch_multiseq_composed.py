"""The port's composed mode (sequences x spatial) and the multi-sequence CLI,
on the CPU.

  * ``{"mode": "spatial", "devices": 4, "sequences": 2}``: two synthetic
    sequences (seeds 0 and 1), each on 2 row shards, against the JAX
    SpatialMultiSeqSystem, at the small geometry of
    tests/test_torch_spatial.py (32x64).  The module list leaves out the
    flow and the temporal vote, whose spatial seams tests/test_torch_spatial.py
    holds: with them the JAX mode's compile took 33 s here, without 13;
  * ``configs/synthetic-multiseq.json`` through the port's CLI.

Every comparison is array_equal (tests/test_torch_slice.py).
"""

import json
import logging
import pathlib

import jax
import numpy as np
from test_torch_faithful import _one_intra_op_thread  # noqa: F401 (fixture)
from test_torch_slice import _assert_tree_equal

from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu_torch.__main__ import main as torch_main
from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.parallel.system import SpatialMultiSeqSystem

REPO = pathlib.Path(__file__).resolve().parent.parent

SRC = {"type": "synthetic", "image_size": [32, 64], "num_frames": 3}
MODULES = [
    {"type": "disparity", "num_disparities": 16, "min_disparity": 1},
    {"type": "disparity_derivative"},
    {"type": "superpixels", "block_size": 8, "initial_iterations": 3, "iterations": 2},
    {"type": "superpixel_disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
     "update_interval": 1},
]
KEYS = ["disparity", "disparity_derivative", "superpixels", "planes",
        "disparity_derivative_histogram"]


def _collect(system):
    seen = {}
    assert system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)})) == 6
    assert not system.failed_frames
    return seen


def _provider_state(system):
    return system.pipeline.modules[-1].host_state()


def test_composed_mode_matches_jax():
    """Sequences x spatial: 2 sequences of 2 row shards each against the JAX
    SpatialMultiSeqSystem on a (seq, spatial) mesh of 4 CPU devices, every
    fetched output of every round, the final state and the provider (its
    updates land inside the run at max_in_flight 1)."""
    parallel = {"mode": "spatial", "devices": 4, "sequences": 2}
    want_sys = jax_build_system(dict(SRC), MODULES, parallel=parallel, extra_fetch_keys=KEYS,
                                max_in_flight=1)
    want = _collect(want_sys)
    system = build_system(dict(SRC), MODULES, parallel=parallel, device="cpu",
                          extra_fetch_keys=KEYS, max_in_flight=1)
    assert isinstance(system, SpatialMultiSeqSystem) and not system.captured
    assert system.pipeline.n == 2 and system.batch == 2
    got = _collect(system)
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for fid in got:
        _assert_tree_equal(got[fid], want[fid], f"round {fid}")
    _assert_tree_equal(system.final_state, jax.tree.map(np.asarray, want_sys.final_state),
                       "final state")
    _assert_tree_equal(_provider_state(system), _provider_state(want_sys), "provider")


def test_cli_runs_the_multiseq_config(tmp_path, monkeypatch, caplog):
    """The shipped config as written: 8 sequences, 2 rounds, and the option
    multiseq does not take dropped with the JAX warning."""
    monkeypatch.chdir(tmp_path)
    with open(REPO / "configs" / "synthetic-multiseq.json") as f:
        assert json.load(f)["parallel"] == {"mode": "multiseq", "batch": 8}
    with caplog.at_level(logging.INFO):
        assert torch_main([str(REPO / "configs" / "synthetic-multiseq.json"), "--device",
                           "cpu", "--max-frames", "2", "--module-timing"]) == 0
    assert "processed 16 frames on cpu" in caplog.text
    assert "multi-sequence mode ignores system options: ['module_timing']" in caplog.text
