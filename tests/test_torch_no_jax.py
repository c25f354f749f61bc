"""The port imports neither JAX nor the JAX package.

The card's machine has no JAX, so nothing the port (or chip_smoke.py)
imports may pull it in: the child below runs the pipelines, the System
with its host modules, sinks and checkpoints, a 2-sequence MultiSeqSystem,
the composed mode, the spatial step's captured body on the CPU, the
multi-device modules (the multihost initializer, two partitions of the
multi-sequence System, the width stencils, the SpatialFlagship preset), the quality
metrics and the memory report, the plane fits with the native build, the
ORB features and the ZED source, and imports the CLI, with any ``import
jax`` made to fail.
"""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "cartslam_tpu_torch"

CHILD = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, {repo!r})
from cartslam_tpu_torch.config import build_pipeline
from cartslam_tpu_torch.runtime import run

src = {{"type": "synthetic", "image_size": [32, 64], "num_frames": 2}}
mods = [
    {{"type": "disparity", "num_disparities": 16, "min_disparity": 0}},
    {{"type": "disparity_derivative"}},
    {{"type": "depth"}},
    {{"type": "superpixels", "block_size": 8, "initial_iterations": 2}},
    {{"type": "optflow"}},
    {{"type": "superpixel_disparity_planeseg",
      "parameter_provider": {{"type": "histogram_peak"}}, "use_temporal_smoothing": True}},
]
pipeline, source = build_pipeline(src, mods, device="cpu")
seen = {{}}
result = run(pipeline, source, on_frame=lambda fid, out: seen.update(out))
assert result.frames == 2 and seen["planes"].shape == (32, 64)
assert seen["optflow"].shape == (32, 64, 2)
# The spatial mode (the parallel package, K5's route): 2 row shards.
from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
pipeline, source = build_pipeline(src, mods, device="cpu",
                                  parallel={{"mode": "spatial", "devices": 2}})
assert isinstance(pipeline, SpatialPipeline)
result = run(pipeline, source, on_frame=lambda fid, out: seen.update(out))
assert result.frames == 2 and seen["planes"].shape == (32, 64)
# The reference-faithful modes ('phase' statistics with two relax phases, the
# faithful temporal vote), the pixel plane segmentation in both temporal
# modes and the grayscale switch.
faithful = [dict(m, relax_phases=2, stats_refresh="phase") if m["type"] == "superpixels"
            else dict(m, temporal_mode="faithful") if m["type"].endswith("planeseg") else m
            for m in mods]
pixel = [{{"type": "optflow"}}, {{"type": "disparity", "num_disparities": 16}},
         {{"type": "disparity_planeseg", "parameter_provider": {{"type": "histogram_peak"}},
          "use_temporal_smoothing": True}}]
for cfg, gray in ((faithful, False), (pixel, False),
                  ([*pixel[:2], dict(pixel[2], temporal_mode="faithful")], False), (mods, True)):
    pipeline, source = build_pipeline(src, cfg, device="cpu", grayscale=gray)
    result = run(pipeline, source, on_frame=lambda fid, out: seen.update(out))
    assert result.frames == 2 and seen["planes"].shape == (32, 64)
# The System through the config reader, with the host visualizations
# and a PNG sink (runtime/system, graphs, checkpoint, timing, the viz
# package and the CLI's module).
import json, os, tempfile
import cartslam_tpu_torch.__main__
from cartslam_tpu_torch.config import read_system_config
from cartslam_tpu_torch.runtime.graphs import CapturedStep
from cartslam_tpu_torch.viz.ui import SampleSink
with tempfile.TemporaryDirectory() as tmp:
    cfg = os.path.join(tmp, "modules.json")
    with open(cfg, "w") as f:
        json.dump(mods + [{{"type": "disparity_planeseg_visualization"}},
                          {{"type": "bev_planeseg_visualization"}}], f)
    with open(os.path.join(tmp, "source.json"), "w") as f:
        json.dump(src, f)
    system = read_system_config(os.path.join(tmp, "source.json"), cfg, device="cpu",
                                image_sink=SampleSink(os.path.join(tmp, "samples"), interval=1),
                                checkpoint_path=os.path.join(tmp, "ck.npz"),
                                checkpoint_interval=2)
    assert system.run() == 2 and not system.failed_frames
    # 3 windows (the plane segmentation, its histogram, the BEV) x 2 frames
    assert len(os.listdir(os.path.join(tmp, "samples"))) == 6
    assert os.path.exists(os.path.join(tmp, "ck.npz"))
# The multi-sequence mode: 2 sequences in lock-step (parallel/multiseq,
# parallel/system), and make_batched_step.
from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.parallel.multiseq import make_batched_step
from cartslam_tpu_torch.parallel.system import MultiSeqSystem
system = build_system(src, mods, device="cpu", extra_fetch_keys=["planes"],
                      parallel={{"mode": "multiseq", "batch": 2}})
assert isinstance(system, MultiSeqSystem)
got = {{}}
assert system.run(on_frame=lambda fid, out: got.update(out)) == 4 and not system.failed_frames
assert got["planes"].shape == (2, 32, 64)
step, init_state, init_params = make_batched_step(system.pipeline, 2)
import torch
frame = {{"left": torch.zeros(2, 32, 64, 3, dtype=torch.uint8),
          "right": torch.zeros(2, 32, 64, 3, dtype=torch.uint8), "frame_id": 2}}
state, out = step(init_state(), frame, init_params())
assert out["planes"].shape == (2, 32, 64)
# The composed mode (2 sequences x 2 shards) and the spatial step's captured
# body over static buffers (runtime/graphs, eagerly on the CPU).
from cartslam_tpu_torch.parallel.system import SpatialMultiSeqSystem
from cartslam_tpu_torch.runtime.graphs import StaticBuffers, _sequence_body
system = build_system(src, mods, device="cpu", extra_fetch_keys=["planes"],
                      parallel={{"mode": "spatial", "devices": 4, "sequences": 2}})
assert isinstance(system, SpatialMultiSeqSystem)
assert system.run() == 4 and not system.failed_frames
pipeline, source = build_pipeline(src, mods, device="cpu",
                                  parallel={{"mode": "spatial", "devices": 2}})
first = source.get_next()
bufs = StaticBuffers(pipeline, first)
bufs.load_frame({{k: torch.from_numpy(first[k]) for k in ("left", "right")}}, 1)
got = _sequence_body(pipeline, bufs, bufs.state, bufs.frame, pipeline.variant(1),
                     frozenset(["planes", "superpixels", "optflow"]))
assert got["planes"].shape == (32, 64)
from cartslam_tpu_torch.sources import SyntheticDataSource
# The multi-device modules: the multihost initializer (a no-op on one host),
# two partitions of the multi-sequence System, the width-sharded stencils
# and the SpatialFlagship preset.
from cartslam_tpu_torch.parallel.distributed import initialize_multihost
from cartslam_tpu_torch.parallel.group import ShardGroup
from cartslam_tpu_torch.parallel.spatial import sharded_classify, sharded_derivative
from cartslam_tpu_torch.parallel.spatial_flagship import SpatialFlagship, SpatialFlagshipConfig
assert initialize_multihost({{}}) is False
pipeline, source = build_pipeline(src, mods[:3], device="cpu")
system = MultiSeqSystem([source, SyntheticDataSource(image_size=(32, 64), num_frames=2, seed=1)],
                        pipeline, devices=["cpu", "cpu"])
assert len(system.partitions) == 2 and system.run() == 4 and not system.failed_frames
group = ShardGroup(2, ["cpu", "cpu"])
deriv, hist = sharded_derivative(group)(torch.zeros(32, 64, dtype=torch.int16))
assert deriv.shape == (32, 64, 2) and hist.shape == (256, 2)
assert sharded_classify(group)(deriv[..., 0], torch.zeros(2, 2, dtype=torch.int32)).shape == (32, 64)
preset = SpatialFlagship(SpatialFlagshipConfig(32, 64, num_disparities=16, block_size=8,
                                               initial_iterations=3, iterations=2), 2,
                         device="cpu")
state, out = preset.make_step("initial")(preset.init_state(), {{"left": frame["left"][0],
                                          "right": frame["right"][0], "frame_id": 1}},
                                         preset.init_params())
assert out["planes"].shape == (32, 64)
# The quality metrics against the synthetic truth, and the memory report.
from cartslam_tpu_torch.utils import memory, quality
gen = SyntheticDataSource(image_size=(32, 64), num_frames=2)
regions = gen.ground_truth_regions(1)
sp = got["superpixels"].numpy()
assert 0.0 <= quality.boundary_recall(regions, sp) <= 1.0
assert quality.undersegmentation_error(regions, sp) >= 0.0
assert quality.flow_epe(got["optflow"].numpy() / 32.0, gen.ground_truth_flow(1)) >= 0.0
assert 0.0 <= quality.plane_accuracy(got["planes"].numpy(), regions, {{0: 0, 1: 1}}) <= 1.0
assert memory.memory_stats() == [{{"device": "cpu"}}]
memory.report_memory_usage()
# The plane fits (host modules on the device, the native region growing and
# its Python route), the ORB features, the ZED source and zed_disparity.
import numpy as np
from cartslam_tpu_torch import native
from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.models import planecluster
sp_mods = [{{"type": "superpixels", "block_size": 8, "initial_iterations": 2}},
           {{"type": "disparity", "num_disparities": 16, "min_disparity": 1}},
           {{"type": "disparity_derivative"}}, {{"type": "depth"}}]
for mtype in ("planefit", "planecluster"):
    system = build_system(src, sp_mods + [{{"type": mtype}}, {{"type": "planefit_visualization"}}],
                          device="cpu")
    got = {{}}
    assert system.run(on_frame=lambda fid, out: got.update(out)) == 2
    assert "planes_eq" in got and not system.failed_frames
assert native.available() and system.host_modules[0].route == "native"
planecluster.grow_clusters_python(np.zeros((4, 4), np.int32), np.zeros((1, 4)),
                                  np.zeros(1, bool), 1)
system = build_system(src, [{{"type": "features", "keypoints": 200}},
                            {{"type": "features_visualization"}}], device="cpu")
assert system.run() == 2 and not system.failed_frames
with tempfile.TemporaryDirectory() as tmp:
    rng = np.random.default_rng(0)
    np.savez(os.path.join(tmp, "rec.npz"),
             left=rng.integers(0, 255, (2, 32, 64, 3), dtype=np.uint8),
             right=rng.integers(0, 255, (2, 32, 64, 3), dtype=np.uint8),
             disparity=rng.uniform(-6, -1, (2, 32, 64)).astype(np.float32),
             fx=100.0, cx=32.0, cy=16.0, baseline=0.1)
    system = build_system({{"type": "zed", "path": os.path.join(tmp, "rec.npz"),
                            "include_disparity": True}},
                          [{{"type": "zed_disparity", "smoothing_radius": 2}},
                           {{"type": "disparity_visualization"}}], device="cpu")
    assert system.run() == 2 and not system.failed_frames
from cartslam_tpu_torch.models.planeseg import DisparityPlaneSegmentationModule
from cartslam_tpu_torch.sources.base import to_grayscale
# The wrappers of the op-level kernels K6 and K7 import without JAX too.
from cartslam_tpu_torch.kernels.sgm import sgm_aggregate
from cartslam_tpu_torch.ops.tally import label_tally
from cartslam_tpu_torch.ops.warp import separable_warp
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m.startswith("jax.") or m == "cartslam_tpu" or m.startswith("cartslam_tpu.")]
assert not bad, bad
print("OK")
"""


def test_port_runs_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", CHILD.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+cartslam_tpu\b"
                         r"|from\s+cartslam_tpu(\.|\s))", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())]
    assert not offenders, offenders
