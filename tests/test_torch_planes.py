"""The port's plane fitting (utils/plane_math.py, utils/threefry.py, the
planefit and planecluster host modules, the native region growing) against
the JAX package, on the CPU.

  * the numpy Threefry copy is array_equal to ``jax.random`` (key, split,
    randint) at the plane math's shapes;
  * ``label_point_table`` (table and counts), ``fit_label_planes``,
    ``ransac_label_planes`` (planes within ATOL, counts equal) and
    ``count_plane_inliers_per_label`` (equal) on a noisy two-surface scene
    with invalid and non-finite points;
  * ``configs/modules/kitti-planefit.json`` and ``kitti-planecluster.json``
    through the port's System and the JAX System, 4 frames of a 64x128
    synthetic source with small disparity and superpixel settings:
    ``planes_eq["assignments"]`` array_equal on every frame, the planes
    within ATOL;
  * the clustering's native route equal to its Python route and to the
    JAX package's native route.

The JAX side runs unjitted (``jax.disable_jit()``), since jitted XLA:CPU
contracts multiply-adds (ROADMAP.md, divergences).  Both sides add each
label's points in pixel order, so ATOL (1e-6) is a margin.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_faithful import _one_intra_op_thread, eager_jax_relax  # noqa: F401 (fixtures)

from cartslam_tpu import native as jnative
from cartslam_tpu.config import build_system as jax_build_system
from cartslam_tpu.models import planecluster as jpc
from cartslam_tpu.models import planefit as jpf
from cartslam_tpu.sources.synthetic import SyntheticDataSource as JSource
from cartslam_tpu.utils import plane_math as J
from cartslam_tpu_torch import native as tnative
from cartslam_tpu_torch.config import build_system
from cartslam_tpu_torch.models import planecluster as tpc
from cartslam_tpu_torch.runtime.module import PipelineContext
from cartslam_tpu_torch.sources import SyntheticDataSource as TSource
from cartslam_tpu_torch.utils import plane_math as T
from cartslam_tpu_torch.utils import threefry

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-6
H, W, FRAMES = 64, 128, 4


def _scene(h=H, w=W, seed=0, block=8):
    """Labels on a jittered block grid and a noisy ground + wall scene, 5%
    non-finite points and 3% beyond the 40 m validity bound."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    labels = ((ys // block) * (w // block) + xs // block).astype(np.int32)
    flip = rng.random((h, w)) < 0.1
    labels[flip] = np.roll(labels, 1, axis=1)[flip]
    z = np.where(ys > h // 2, 40.0 * (h // 2) / np.maximum(ys - h // 2 + 1, 1), 10.0 + xs * 0.05)
    z = z + rng.normal(0, 0.005, (h, w))
    depth = np.stack([(xs - w / 2) * z / 100.0, (ys - h / 2) * z / 100.0, z], -1)
    depth = depth.astype(np.float32)
    depth[rng.random((h, w)) < 0.05] = np.inf
    depth[rng.random((h, w)) < 0.03, 2] = 50.0
    zz = depth[..., 2]
    valid = np.isfinite(zz) & (zz > 0) & (zz <= 40)
    return labels, depth, valid, int(labels.max()) + 1


def _both(labels, depth, valid):
    return ((jnp.asarray(labels), jnp.asarray(depth), jnp.asarray(valid)),
            (torch.from_numpy(labels), torch.from_numpy(depth), torch.from_numpy(valid)))


# ------------------------------------------------------------------ threefry

@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_threefry_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.prng_key(seed), np.asarray(jax.random.key_data(key)))
    np.testing.assert_array_equal(threefry.split(threefry.prng_key(seed), 16),
                                  np.asarray(jax.random.split(key, 16)))
    # The plane math's draws: a per-pixel key and, per hypothesis, [L, 3].
    for shape, hi in (((H * W,), 1 << 20), ((129, 3), 1 << 30), ((5,), 100)):
        want = np.asarray(jax.random.randint(key, shape, 0, hi))
        got = threefry.randint(threefry.prng_key(seed), shape, 0, hi)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_ransac_draws_match_the_jax_draws():
    L, n = 37, 300
    d = T.ransac_draws(n, L, hypotheses=16, seed=0)
    np.testing.assert_array_equal(
        d["mix"].numpy(), np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n,), 0, 1 << 20)))
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    want = jax.vmap(lambda k: jax.random.randint(k, (L, 3), 0, 1 << 30))(keys)
    np.testing.assert_array_equal(d["hyp"].numpy(), np.asarray(want))


# ---------------------------------------------------------------- plane math

def test_label_point_table_matches_jax():
    labels, depth, valid, L = _scene()
    j, t = _both(labels, depth, valid)
    with jax.disable_jit():
        jt, jc = J.label_point_table(*j, L, 64)
    tt, tc = T.label_point_table(*t, L, 64)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("method", ["lsq", "ransac"])
def test_label_planes_match_jax(method):
    labels, depth, valid, L = _scene(seed=1)
    j, t = _both(labels, depth, valid)
    with jax.disable_jit():
        jp, jn = (J.fit_label_planes(*j, L) if method == "lsq"
                  else J.ransac_label_planes(*j, L))
    tp, tn = T.fit_label_planes(*t, L) if method == "lsq" else T.ransac_label_planes(*t, L)
    assert (np.linalg.norm(np.asarray(jp), axis=1) > 0).sum() > L // 3
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_moments_match_jax():
    labels, depth, valid, L = _scene(seed=2)
    j, t = _both(labels, depth, valid)
    with jax.disable_jit():
        jm = J.label_point_moments(*j, L)
    tm = T.label_point_moments(*t, L)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-6, atol=0,
                                   err_msg=k)


def test_inlier_counts_match_jax():
    labels, depth, valid, L = _scene(seed=3)
    j, t = _both(labels, depth, valid)
    with jax.disable_jit():
        planes = np.asarray(J.ransac_label_planes(*j, L)[0])
        planes = planes[np.linalg.norm(planes, axis=1) > 0][:10]
        want = np.asarray(J.count_plane_inliers_per_label(*j, jnp.asarray(planes), L, 0.02))
    got = T.count_plane_inliers_per_label(*t, torch.from_numpy(planes), L, 0.02)
    assert got.dtype == torch.int32 and want.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- the modules

def _module_config(name):
    """The module config with small disparity and superpixel settings: 16
    disparities from 1 (the disparity smoothing keeps values below the
    image width, 8 px at 128 columns), 8-pixel superpixels."""
    mods = json.loads((REPO / "configs" / "modules" / f"kitti-{name}.json").read_text())
    for m in mods:
        if m["type"] == "superpixels":
            m.update(block_size=8, initial_iterations=3, iterations=2)
        elif m["type"] == "disparity":
            m.update(num_disparities=16, min_disparity=1)
        elif m["type"] == "optflow":
            m.update(levels=3, search=2, refine=1)
    return mods


def _source(cls):
    """A 0.02 m baseline puts the scene within 1-2 m, where the 0.02 m
    inlier bound admits the quantized ground plane."""
    return cls(image_size=(H, W), num_frames=FRAMES, seed=0, max_disparity=7.5, baseline=0.02)


def _collect(system):
    seen = {}
    assert system.run(on_frame=lambda fid, out: seen.update({fid: dict(out)})) == FRAMES
    assert not system.failed_frames
    return seen


@pytest.fixture(scope="module")
def jax_plane_runs():
    """The JAX System (step unjitted, relax eager, host modules under
    disable_jit) on both module configs."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jpf.SuperPixelPlaneFitModule, jpc.SuperPixelPlaneClusterModule):
            def eager(self, *a, _process=cls.process, **kw):
                with jax.disable_jit():
                    return _process(self, *a, **kw)
            mp.setattr(cls, "process", eager)
        for name in ("planefit", "planecluster"):
            system = jax_build_system(_source(JSource), _module_config(name))
            pipe = system.pipeline
            pipe.jitted_step = lambda variant, fetch_keys, p=pipe: p.make_step(variant, fetch_keys)
            runs[name] = _collect(system)
    return runs


@pytest.mark.parametrize("name", ["planefit", "planecluster"])
def test_plane_module_matches_jax_system(jax_plane_runs, name):
    want = jax_plane_runs[name]
    system = build_system(_source(TSource), _module_config(name), device="cpu")
    got = _collect(system)
    assigned = 0
    for fid in range(1, FRAMES + 1):
        a, b = got[fid]["planes_eq"], want[fid]["planes_eq"]
        np.testing.assert_array_equal(a["assignments"], b["assignments"], err_msg=f"frame {fid}")
        np.testing.assert_allclose(np.asarray(a["planes"], np.float64),
                                   np.asarray(b["planes"], np.float64), rtol=0, atol=ATOL)
        assigned += int((a["assignments"] > 0).sum())
    assert assigned > 0  # planes were adopted: the comparison is not vacuous
    if name == "planecluster":
        assert system.host_modules[0].route == "native"


def _cluster_scene():
    """tests/test_planes.py's scene at 64 rows: 8-pixel blocks on a ground
    plane that bends into a ramp halfway down."""
    h, w, bs = H, W, 8
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    labels = ((ys // bs) * (w // bs) + (xs // bs)).astype(np.int32)
    depth = np.zeros((h, w, 3), np.float32)
    depth[..., 0] = xs * 0.05
    depth[..., 1] = np.where(ys < h // 2, 1.5, 0.1 * (ys - h // 2) + 1.5)
    depth[..., 2] = 3.0 + ys * 0.05
    return labels, depth, int(labels.max()) + 1


@pytest.mark.parametrize("scene", ["ramp", "noisy"])
def test_cluster_routes_agree(scene, monkeypatch):
    """The port's native route == its Python route == the JAX package's
    native route, on the same labels and depth."""
    if scene == "ramp":
        labels, depth, L = _cluster_scene()
    else:
        labels, depth, _, L = _scene(seed=4)
    assert tnative.available() and jnative.available()
    ctx = PipelineContext(height=labels.shape[0], width=labels.shape[1],
                          q=np.eye(4, dtype=np.float32), device="cpu")
    fetched = {"superpixels": labels, "depth": depth}
    mod = tpc.SuperPixelPlaneClusterModule(num_labels=L, min_cluster=4 if scene == "noisy" else 32)
    nat = mod.process(ctx, 1, {}, fetched, {})["planes_eq"]
    assert mod.route == "native"
    monkeypatch.setattr(tnative, "available", lambda: False)
    py = mod.process(ctx, 1, {}, fetched, {})["planes_eq"]
    assert mod.route == "python"
    with jax.disable_jit():
        jmod = jpc.SuperPixelPlaneClusterModule(num_labels=L, min_cluster=mod.min_cluster)
        ref = jmod.process(None, 1, {}, fetched, {})["planes_eq"]
    assert (nat["assignments"] > 0).sum() >= mod.min_cluster
    for other in (py, ref):
        np.testing.assert_array_equal(nat["assignments"], other["assignments"])
        np.testing.assert_allclose(np.asarray(nat["planes"], np.float64),
                                   np.asarray(other["planes"], np.float64), rtol=0, atol=ATOL)


def test_native_library_builds_into_the_build_directory():
    from cartslam_tpu_torch.native.build import BUILD_DIR, build

    path = build()
    assert path.parent == BUILD_DIR and path.exists()
    assert BUILD_DIR == REPO / "build" / "cartslam_tpu_torch"
    assert not list((REPO / "cartslam_tpu_torch" / "native").glob("*.so"))
