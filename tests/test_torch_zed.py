"""The port's ZED source and zed_disparity module against the JAX package,
and the shipped top-level configs of this slice on the CPU.

The test writes its own recordings (npz and dir formats, as
tests/test_sources.py does) from synthetic frames plus an SDK-style
measure: minus the true disparity, inf where the SDK has none, and values
beyond the int16 range.

  * source frames, Q and the measure equal the JAX source's (both formats,
    the measure's missing-file inf fill included);
  * ``zed_disparity`` array_equal, full frame and on 2 spatial shards;
  * ``configs/modules/zed-planeseg.json`` (superpixels at block 16 -> 8 at
    this size, zed_disparity, a static provider) through the port's System
    against the JAX System, every fetched output of every frame equal;
  * configs/kitti-planefit.json, kitti-planecluster.json,
    kitti-features.json, zed-disparity.json and zed-planeseg.json through
    ``read_system_config(..., device="cpu")`` with their data paths swapped
    for a synthetic source or the recording.

The JAX steps run unjitted, with the eager relax of
tests/test_torch_faithful.py.  Every comparison is array_equal (depth
within 2 ulp, as in tests/test_torch_system.py).
"""

import json
import pathlib

import numpy as np
import pytest
from test_torch_faithful import _one_intra_op_thread, eager_jax_relax  # noqa: F401 (fixtures)
from test_torch_slice import _assert_tree_equal

from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.sources.zed import ZEDDataSource as JZed
from cartslam_tpu_torch.config import build_system, read_system_config
from cartslam_tpu_torch.sources import SyntheticDataSource, ZEDDataSource
from cartslam_tpu_torch.utils.imageio import imwrite_bgr

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W, FRAMES = 64, 128, 4
KEYS = ["disparity", "disparity_derivative", "disparity_derivative_histogram", "depth",
        "optflow", "superpixels", "superpixels_max_label", "planes", "planes_unsmoothed"]


def _recording(frames=FRAMES, h=H, w=W, seed=0):
    """(left, right, measure) arrays of a synthetic drive: the measure is
    minus the true disparity, inf in the top rows and a random 5% of pixels
    (no SDK depth), and -2100 px (beyond int16 once scaled) in one block."""
    src = SyntheticDataSource(image_size=(h, w), num_frames=frames, seed=seed,
                              max_disparity=7.5, baseline=0.02)
    rng = np.random.default_rng(seed)
    lefts, rights, measures = [], [], []
    for i in range(frames):
        f = src.get_next()
        m = -src.ground_truth_disparity(i).astype(np.float32)
        m[:3] = np.inf
        m[rng.random((h, w)) < 0.05] = np.inf
        m[10:14, 20:30] = -2100.0
        lefts.append(f["left"])
        rights.append(f["right"])
        measures.append(m)
    return np.stack(lefts), np.stack(rights), np.stack(measures)


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """{"npz": path, "dir": path} of the same recording; the dir format has
    no measure file for frame 2 (the source fills inf)."""
    root = tmp_path_factory.mktemp("zed")
    left, right, disp = _recording()
    meta = dict(fx=100.0, cx=W / 2, cy=H / 2, baseline=0.02)
    npz = root / "rec.npz"
    np.savez(npz, left=left, right=right, disparity=disp, **meta)
    d = root / "rec"
    for side, imgs in (("left", left), ("right", right)):
        (d / side).mkdir(parents=True)
        for i, img in enumerate(imgs):
            imwrite_bgr(str(d / side / f"{i:06d}.png"), img)
    (d / "disparity").mkdir()
    for i, m in enumerate(disp):
        if i != 2:
            np.save(d / "disparity" / f"{i:06d}.npy", m)
    (d / "intrinsics.json").write_text(json.dumps({**meta, "cx_right": W / 2 - 1.5}))
    return {"npz": str(npz), "dir": str(d)}


@pytest.mark.parametrize("fmt", ["npz", "dir"])
@pytest.mark.parametrize("include_disparity", [True, False])
def test_zed_source_matches_jax(recordings, fmt, include_disparity):
    a = ZEDDataSource(recordings[fmt], include_disparity=include_disparity)
    b = JZed(recordings[fmt], include_disparity=include_disparity)
    assert a.get_image_size() == b.get_image_size() == (H, W)
    np.testing.assert_array_equal(a.get_camera_intrinsics().q, b.get_camera_intrinsics().q)
    n = 0
    while not b.is_finished():
        fa, fb = a.get_next(), b.get_next()
        assert sorted(fa) == sorted(fb)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"frame {n} {k}")
        n += 1
    assert n == FRAMES and a.is_finished() and a.get_next() is None
    if include_disparity and fmt == "dir":
        c = ZEDDataSource(recordings[fmt], include_disparity=True)
        c.skip(2)
        assert np.isinf(c.get_next()["zed_disparity"]).all()


def _run(system):
    seen = {}
    assert system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)})) == FRAMES
    assert not system.failed_frames
    return seen


def _jax_system(source_cfg, modules, **kw):
    system = jax_build_system(source_cfg, modules, **kw)
    pipe = system.pipeline
    pipe.jitted_step = lambda variant, fetch_keys: pipe.make_step(variant, fetch_keys)
    return system


@pytest.mark.parametrize("shards", [0, 2])
def test_zed_disparity_matches_jax(recordings, shards):
    """configs/zed-disparity.json's module (smoothing radius 2, one
    iteration), full frame and on 2 row shards, against the JAX full frame:
    the measure x(-16), clipped to int16, inf to -32768."""
    src = {"type": "zed", "path": recordings["npz"], "include_disparity": True}
    mods = [m for m in json.loads((REPO / "configs" / "zed-disparity.json").read_text())["modules"]
            if m["type"] == "zed_disparity"]
    want = _run(_jax_system(src, mods, extra_fetch_keys=["disparity"]))
    kw = {"parallel": {"mode": "spatial", "devices": shards}} if shards else {}
    got = _run(build_system(src, mods, extra_fetch_keys=["disparity"], device="cpu", **kw))
    plain = _run(build_system(src, [{"type": "zed_disparity"}], extra_fetch_keys=["disparity"],
                              device="cpu"))
    _, _, disp = _recording()
    for fid in range(1, FRAMES + 1):
        np.testing.assert_array_equal(got[fid]["disparity"], want[fid]["disparity"])
        d = plain[fid]["disparity"]
        assert d.dtype == np.int16 and (d[:3] == -32768).all() and (d[10:14, 20:30] == 32767).all()
        m = disp[fid - 1]
        ok = np.isfinite(m)
        np.testing.assert_array_equal(d[ok], np.clip(m[ok] * -16.0, -32768, 32767).astype(np.int16))


def test_zed_planeseg_modules_match_jax(recordings):
    """configs/modules/zed-planeseg.json (superpixel block 8 at this size)
    on the npz recording: the port's System against the JAX System."""
    mods = json.loads((REPO / "configs" / "modules" / "zed-planeseg.json").read_text())
    for m in mods:
        if m["type"] == "superpixels":
            m.update(block_size=8, initial_iterations=3, iterations=2)
        elif m["type"] == "optflow":
            m.update(levels=3, search=2, refine=1)
    src = {"type": "zed", "path": recordings["npz"], "include_disparity": True}
    want = _run(_jax_system(src, mods, extra_fetch_keys=KEYS))
    got = _run(build_system(src, mods, extra_fetch_keys=KEYS, device="cpu"))
    for fid in range(1, FRAMES + 1):
        _assert_tree_equal({k: got[fid][k] for k in KEYS}, {k: want[fid][k] for k in KEYS},
                           f"frame {fid}")
    assert (got[FRAMES]["planes"] != 2).any()  # some pixels classified


CONFIGS = ["kitti-planefit", "kitti-planecluster", "kitti-features", "zed-disparity",
           "zed-planeseg"]


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_config_runs_on_the_cpu(recordings, tmp_path, name):
    """The top-level config through read_system_config on the CPU, its data
    source swapped for a 64x128 synthetic one (KITTI) or the recording
    (ZED), 2 frames, small disparity and keypoint settings."""
    cfg = json.loads((REPO / "configs" / f"{name}.json").read_text())
    if cfg["data_source"]["type"] == "zed":
        cfg["data_source"]["path"] = recordings["npz"]
    else:
        cfg["data_source"] = {"type": "synthetic", "image_size": [H, W], "num_frames": 2}
    for m in cfg["modules"]:
        if m["type"] == "disparity":
            m.update(num_disparities=16, min_disparity=1)
        elif m["type"] == "superpixels":
            m.update(block_size=8, initial_iterations=2, iterations=1)
        elif m["type"] == "features":
            m.update(keypoints=500)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    system = read_system_config(str(path), device="cpu", max_frames=2)
    seen = {}
    assert system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)})) == 2
    assert not system.failed_frames and sorted(seen) == [1, 2]
    types = {m["type"] for m in cfg["modules"]}
    if types & {"planefit", "planecluster"}:
        assert all("planes_eq" in seen[f] for f in (1, 2))
    if "features" in types:
        assert seen[2]["features"].shape == (2, 500, 4)
