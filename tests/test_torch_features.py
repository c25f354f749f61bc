"""The port's ORB features (ops/features.py, models/features.py, the
feature visualization) against the JAX package, on the CPU.

  * ``fast_score`` and ``_nms3`` array_equal;
  * ``detect_orb`` on the same level image (the resize out of the compare):
    keypoints array_equal, the order of tied scores included, on a blocky
    image with many equal scores and more slots than corners; descriptors
    within DESC_BITS differing bits (arctan2 / cos / sin round differently
    in the two libraries);
  * the antialiased resize alone: at most 1 gray level apart on at most
    RESIZE_SHARE of the pixels;
  * the module through the port's Pipeline against the JAX module: level 0
    exactly, levels 1 and 2 within the resize's tolerance;
  * the step body reads nothing back to the host (it is captured on a card);
  * ``FeatureVisualization`` and ``PlaneFitVisualization`` against JAX's.

The JAX side runs unjitted (``jax.disable_jit()``).  The bounds leave room
for another CPU's libm and summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_system import _HostReads

from cartslam_tpu.models.features import ImageFeatureDetectorModule as JModule
from cartslam_tpu.ops import features as J
from cartslam_tpu.runtime.module import PipelineContext as JContext
from cartslam_tpu.runtime.module import StepContext as JStep
from cartslam_tpu.viz import host_modules as jvm
from cartslam_tpu_torch.config import build_pipeline
from cartslam_tpu_torch.ops import features as T
from cartslam_tpu_torch.runtime import run
from cartslam_tpu_torch.runtime.loop import frame_to_device
from cartslam_tpu_torch.sources import SyntheticDataSource
from cartslam_tpu_torch.viz import host_modules as tvm

H, W = 64, 128
K = 1000
DESC_BITS = 16  # of 256 bits x K keypoints
RESIZE_SHARE = 0.005
LEVEL_ROWS = 0.02  # share of a level's keypoint rows the resize may change


def _blocky(seed=0, h=H, w=W, block=4):
    """Four gray levels in blocks: many equal FAST scores."""
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 4, (h // block, w // block)) * 60).astype(np.uint8)
    return np.kron(img, np.ones((block, block), np.uint8))


def _random(seed=1, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)


def _bits_differ(a, b) -> int:
    return int(np.unpackbits((np.asarray(a) ^ np.asarray(b)).view(np.uint8)).sum())


@pytest.mark.parametrize("image", ["blocky", "random"])
def test_fast_score_and_nms_match_jax(image):
    g = _blocky() if image == "blocky" else _random()
    with jax.disable_jit():
        js = np.asarray(J.fast_score(jnp.asarray(g)))
        jn = np.asarray(J._nms3(jnp.asarray(js)))
    ts = T.fast_score(torch.from_numpy(g))
    assert ts.dtype == torch.int32 and (js > 0).sum() > 100
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(T._nms3(ts).numpy(), jn)


@pytest.mark.parametrize("image,k", [("blocky", 2000), ("random", 1500)])
def test_detect_orb_matches_jax(image, k):
    g = _blocky() if image == "blocky" else _random()
    with jax.disable_jit():
        jk, jd = (np.asarray(a) for a in J.detect_orb(jnp.asarray(g), k))
    tk, td = T.detect_orb(torch.from_numpy(g), k)
    n_valid = int((jk[:, 2] > 0).sum())
    if image == "blocky":
        # More slots than corners: the zero-score slots tie, and lax.top_k
        # gives them in index order.
        assert n_valid < k and len(np.unique(jk[:n_valid, 2])) < n_valid
    np.testing.assert_array_equal(tk.numpy(), jk)
    assert td.dtype == torch.uint32 and td.shape == (k, 8)
    assert _bits_differ(td.numpy(), jd) <= DESC_BITS


@pytest.mark.parametrize("level", [1, 2])
def test_resize_matches_jax(level):
    g = _random(seed=level, h=96, w=192)
    lh, lw = T.level_shape(96, 192, level, 1.4142135)
    with jax.disable_jit():
        want = np.asarray(jnp.clip(jnp.round(jax.image.resize(
            jnp.asarray(g, jnp.float32), (lh, lw), "linear")), 0, 255).astype(jnp.uint8))
    got = T.resize_linear(torch.from_numpy(g), (lh, lw)).numpy()
    diff = np.abs(got.astype(np.int32) - want)
    assert got.shape == want.shape and diff.max() <= 1
    assert (diff > 0).mean() <= RESIZE_SHARE


def test_resize_weights_match_jax():
    """The weights equal JAX's where its column sums add in order; on longer
    axes XLA's reduce adds in another order, and a few weights (at most
    1e-4 of them) differ by one ulp."""
    from jax._src.image import scale as jscale

    for n_in, n_out in ((128, 91), (128, 64), (64, 45), (376, 266)):
        with jax.disable_jit():
            want = np.asarray(jscale.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                                        jscale._fill_triangle_kernel, True))
        got = T.resize_weights(n_in, n_out)
        if n_in <= 128:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
        assert (got != want).mean() <= 1e-4


def _frames(n=2):
    src = SyntheticDataSource(image_size=(H, W), num_frames=n, seed=3)
    return [src.get_next() for _ in range(n)]


def test_features_module_matches_jax():
    """configs/kitti-features.json's device module (3 levels; 1000
    keypoints for the test's time, the config's 5000 on the card) through
    the port's Pipeline against the JAX module."""
    frames = _frames()
    pipe, source = build_pipeline(SyntheticDataSource(image_size=(H, W), num_frames=2, seed=3),
                                  [{"type": "features", "keypoints": K}], device="cpu")
    seen = {}
    run(pipe, source,
        on_frame=lambda fid, out: seen.update({fid: {k: v.numpy() for k, v in out.items()}}))
    jmod = JModule(max_keypoints=K)
    jctx = JContext(height=H, width=W, q=np.eye(4, dtype=np.float32))
    ks = T.level_budgets(K, 3, 1.4142135)
    for fid, frame in enumerate(frames, start=1):
        with jax.disable_jit():
            out, _ = jmod.compute(jctx, JStep({k: jnp.asarray(v) for k, v in frame.items()}, {}),
                                  {}, {}, {}, None)
        jf, jd = np.asarray(out["features"]), np.asarray(out["feature_descriptors"])
        tf, td = seen[fid]["features"], seen[fid]["feature_descriptors"]
        assert tf.shape == jf.shape == (2, K, 4) and td.dtype == np.uint32
        assert (jf[..., 2] > 0).sum() > 100
        np.testing.assert_array_equal(tf[:, :ks[0]], jf[:, :ks[0]])  # level 0: no resize
        rows = (tf[:, ks[0]:] != jf[:, ks[0]:]).any(-1).mean()
        assert rows <= LEVEL_ROWS, rows
        assert _bits_differ(td[:, :ks[0]], jd[:, :ks[0]]) <= DESC_BITS


def test_features_step_reads_nothing_back():
    """The features module's step body (captured into the System's CUDA
    graph on a card) reads nothing back to the host and copies nothing in
    once its constants are made."""
    pipe, source = build_pipeline(SyntheticDataSource(image_size=(H, W), num_frames=3, seed=3),
                                  [{"type": "features", "keypoints": 1000}], device="cpu")
    state = pipe.init_state()
    params = pipe.device_params(pipe.init_host_params())
    for fid in range(1, 4):
        frame, _ = pipe.prepare(frame_to_device(source.get_next(), fid, "cpu"), params)
        with _HostReads() as reads:
            state, _ = pipe.compute_step(state, frame, params, pipe.variant(fid))
        # Frame 1 makes the constants (the pattern, two levels' weights).
        assert len(reads.found) == (5 if fid == 1 else 0), (fid, reads.found)


@pytest.mark.parametrize("name", ["FeatureVisualization", "PlaneFitVisualization"])
def test_visualization_matches_jax(name):
    rng = np.random.default_rng(5)
    frame = {"left": rng.integers(0, 256, (H, W, 3)).astype(np.uint8)}
    labels = rng.integers(0, 40, (H, W)).astype(np.int32)
    feats = np.zeros((2, 50, 4), np.float32)
    feats[..., 0] = rng.integers(0, W, (2, 50))
    feats[..., 1] = rng.integers(0, H, (2, 50))
    feats[:, :30, 2] = rng.integers(1, 90, (2, 30))
    fetched = {"features": feats, "superpixels": labels,
               "planes_eq": {"planes": np.ones((3, 4), np.float32),
                             "assignments": rng.integers(0, 4, 40)}}
    want = getattr(jvm, name)().render(None, 1, frame, fetched, {})
    got = getattr(tvm, name)().render(None, 1, frame, fetched, {})
    np.testing.assert_array_equal(got, want)
    if name == "PlaneFitVisualization":  # planes_eq from globals_ when not fetched
        rest = {k: v for k, v in fetched.items() if k != "planes_eq"}
        glob = {"planes_eq": fetched["planes_eq"]}
        np.testing.assert_array_equal(tvm.PlaneFitVisualization().render(None, 1, frame, rest, glob),
                                      jvm.PlaneFitVisualization().render(None, 1, frame, rest, glob))
