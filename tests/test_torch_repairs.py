"""Two faults of the port against the JAX package, repaired, on the CPU.

  * C4: ``--module-timing`` on the spatial mode.  The port's spatial
    System with ``module_timing=True`` writes the JAX System's rows: one
    ``spatial_step`` row a frame beside the frame and system rows.
  * C5: the CLI's PNG sampler.  A 5-frame ``--save-samples`` run writes no
    PNG in either package (the samplers write the frames with frame_id %
    30 == 0); the port's write at close is the sink's opt-in
    ``SampleSink(write_last_on_close=True)``.
"""

import csv
import functools
import json

import numpy as np

from cartslam_tpu.__main__ import main as jax_main
from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.runtime.timing import TimingWriter as JTiming
from cartslam_tpu_torch.__main__ import main as torch_main
from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.runtime.timing import TimingWriter
from cartslam_tpu_torch.viz import ui
from cartslam_tpu_torch.viz.ui import SampleSink

SOURCE = {"type": "synthetic", "image_size": [32, 64], "num_frames": 2}
MODULES = [{"type": "disparity", "num_disparities": 16, "min_disparity": 1},
           {"type": "disparity_derivative"}]
SPATIAL = {"mode": "spatial", "devices": 2}


def _rows(directory):
    (path,) = directory.glob("timing-*.csv")
    with open(path) as f:
        rows = list(csv.reader(f, delimiter=";"))
    return rows[0], rows[1:]


def test_spatial_module_timing_rows_match_jax(tmp_path):
    runs = {}
    for pkg, build, timing_cls, kw in (("jax", jax_build_system, JTiming, {}),
                                       ("port", build_system, TimingWriter, {"device": "cpu"})):
        timing = timing_cls(str(tmp_path / pkg))
        seen = {}
        system = build(SOURCE, MODULES, parallel=SPATIAL, module_timing=True, timing=timing,
                       extra_fetch_keys=["disparity"], **kw)
        assert system.run(on_frame=lambda fid, out: seen.update({fid: out})) == 2
        timing.close()
        runs[pkg] = (_rows(tmp_path / pkg), seen)
    (jhead, jrows), jseen = runs["jax"]
    (thead, trows), tseen = runs["port"]
    assert thead == jhead
    assert [(r[0], r[1]) for r in trows] == [(r[0], r[1]) for r in jrows]
    assert [r[1] for r in trows if r[0] == "spatial_step"] == ["1", "2"]
    for r in trows:
        assert float(r[5]) >= 0 and float(r[4]) >= float(r[3])
    for fid in (1, 2):
        np.testing.assert_array_equal(tseen[fid]["disparity"], jseen[fid]["disparity"])


def test_short_cli_run_writes_no_samples(tmp_path, monkeypatch):
    """5 frames with --save-samples: no PNG from either CLI, and the port's
    sink with its opt-in writes the last frame of each window."""
    (tmp_path / "source.json").write_text(json.dumps(dict(SOURCE, num_frames=5)))
    (tmp_path / "modules.json").write_text(json.dumps(
        MODULES[:1] + [{"type": "disparity_visualization"}]))
    cfgs = [str(tmp_path / "source.json"), str(tmp_path / "modules.json")]
    found = {}
    opt_in = functools.partial(SampleSink, write_last_on_close=True)
    for pkg, main, extra, sink in (("jax", jax_main, [], SampleSink),
                                   ("port", torch_main, ["--device", "cpu"], SampleSink),
                                   ("opt-in", torch_main, ["--device", "cpu"], opt_in)):
        run_dir = tmp_path / pkg
        run_dir.mkdir()
        monkeypatch.chdir(run_dir)
        monkeypatch.setattr(ui, "SampleSink", sink)
        assert main([*cfgs, "--max-frames", "5", "--save-samples", *extra]) in (0, None)
        found[pkg] = sorted(p.name for p in (run_dir / "samples").iterdir())
    assert found["jax"] == found["port"] == []
    assert found["opt-in"] == ["ImageDisparityVisualization-000005.png"]


def test_sample_sink_writes_the_interval_frames(tmp_path):
    sink = SampleSink(directory=str(tmp_path), interval=2)
    img = np.full((4, 6, 3), 7, np.uint8)
    for fid in (1, 2, 3):
        sink.set_image_if_later("plane seg", img, fid)
    sink.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["plane_seg-000002.png"]
