"""The port's reference-faithful modes against the JAX package, on the CPU.

Held here, every comparison array_equal (integer outputs):

  * ``ops/superpixels.relax`` for the four (phases, stats_refresh) pairs of
    tests/test_relax_pallas.py, a progressive-compactness layout and a
    grayscale (5-channel) layout; and its spatial 'phase' mode (shards with
    ``iterations x phases``-row halos, psum'd re-tallies, global
    checkerboard rows) against JAX's unsharded op;
  * the reference-faithful temporal vote (K gathers of the previous planes)
    and the pixel module's low-pass derivative with its histogram;
  * the faithful flagship (the six modules with 'phase' statistics, two
    relax phases and the faithful vote) over 6 frames, every output, the
    state and the host params, and resumed from the JAX state.

The JAX relax runs eagerly (see _eager_relax).  The torch ops run on one
intra-op thread, as tests/test_torch_spatial.py does, so the file's time
does not hang on the machine's load.  The pixel plane segmentation and the
grayscale switch are in tests/test_torch_pixel_planeseg.py.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slice import _assert_tree_equal

from cartslam_tpu import models as jm
from cartslam_tpu.ops import derivative as jder
from cartslam_tpu.ops import planeseg as jps
from cartslam_tpu.ops import superpixels as jsp
from cartslam_tpu.runtime.module import PipelineContext as JContext
from cartslam_tpu.runtime.pipeline import Pipeline as JPipeline
from cartslam_tpu.sources.synthetic import SyntheticDataSource
from cartslam_tpu.utils.plane_params import HistogramPeakPlaneParameterProvider as JProvider
from cartslam_tpu_torch import models as tm
from cartslam_tpu_torch.config import build_pipeline
from cartslam_tpu_torch.kernels import build as kbuild
from cartslam_tpu_torch.kernels import relax as krelax
from cartslam_tpu_torch.ops import color as tcolor
from cartslam_tpu_torch.ops import derivative as tder
from cartslam_tpu_torch.ops import planeseg as tps
from cartslam_tpu_torch.ops import superpixels as tsp
from cartslam_tpu_torch.parallel.group import ShardGroup
from cartslam_tpu_torch.runtime import (
    Pipeline,
    PipelineContext,
    host_step,
    state_from_reference,
    state_to_numpy,
)
from cartslam_tpu_torch.runtime.loop import frame_to_device
from cartslam_tpu_torch.runtime.module import SpatialContext
from cartslam_tpu_torch.utils.plane_params import HistogramPeakPlaneParameterProvider as TProvider

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eager_relax(*args, **kw):
    """The JAX relax run op by op, its tallies (one scatter each) compiled.
    Jitted as a whole, XLA:CPU contracts a*b + c into FMAs in the sweep's
    cost arithmetic, where the port (and the kernel, built with -fmad=false)
    rounds after each operation, so the tests compare against the eager
    call (ROADMAP.md, divergences): the -32768 invalid derivatives in the
    superpixel features make near-ties that such a rounding flips."""
    with jax.disable_jit():
        return _JAX_RELAX(*args, **kw)


def _jitted_init_stats(*args, **kw):
    with jax.disable_jit(False):
        return _JAX_INIT_STATS(*args, **kw)


_JAX_RELAX = jsp.relax
_JAX_INIT_STATS = jax.jit(jsp.init_stats,
                          static_argnames=("num_labels", "use_matmul", "channel_bounds", "vma"))


@pytest.fixture(autouse=True, scope="module")
def eager_jax_relax():
    """Every JAX relax of this module (direct, or inside a JAX pipeline's
    unjitted step) runs eagerly."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsp, "relax", _eager_relax)
        mp.setattr(jsp, "init_stats", _jitted_init_stats)
        yield


# ------------------------------------------------------------------ relax

RH, RW, BLOCK, ITERS = 48, 96, 6, 3
DIAG = 0.3536
# name -> (gaussian (name, channels, weight) in order, progressive factor)
LAYOUTS = {
    "flagship": ((("deriv", 2, 1.0), ("ycrcb", 3, 1.5)), 0.0),
    "progressive": ((("deriv", 2, 1.0), ("ycrcb", 3, 1.5)), 1.0),
    "grayscale": ((("deriv", 2, 1.0), ("gray", 1, 1.5)), 0.0),
}


@functools.lru_cache(maxsize=None)
def _relax_inputs(layout):
    """(labels, feature arrays [H, W, C], specs as tuples, num_labels): the
    synthetic frame's YCrCb or gray image and a random derivative."""
    f = SyntheticDataSource(image_size=(RH, RW), num_frames=1, seed=0).get_next()
    left = torch.from_numpy(f["left"])
    planes = {"ycrcb": tcolor.bgr_to_ycrcb(left).numpy().astype(np.float32),
              "gray": tcolor.bgr_to_gray(left).numpy().astype(np.float32)[..., None],
              "deriv": np.random.RandomState(0).randint(-30, 30, (RH, RW, 2))
              .astype(np.float32)}
    gauss, prog = LAYOUTS[layout]
    data = [planes[name] for name, _, _ in gauss]
    specs = [("gaussian", weight, ch, 0.0) for _, ch, weight in gauss]
    specs.append(("compactness", 0.1, 2, prog))
    labels, max_id = jsp.block_init_labels(RH, RW, BLOCK, BLOCK)
    return np.array(labels), data, specs, max_id + 1


@functools.lru_cache(maxsize=None)
def _jax_relax(layout, phases, stats_refresh):
    labels, data, specs, num = _relax_inputs(layout)
    out = _eager_relax(jnp.asarray(labels), [jnp.asarray(d) for d in data],
                    [jsp.FeatureSpec(*s) for s in specs], num, ITERS, 0.5, DIAG,
                    phases=phases, stats_refresh=stats_refresh, backend="xla")
    return np.asarray(out)


def _port_relax(layout, phases, stats_refresh, labels=None, data=None, **kw):
    lab0, data0, specs, num = _relax_inputs(layout)
    labels = torch.from_numpy(lab0) if labels is None else labels
    data = [torch.from_numpy(d) for d in data0] if data is None else data
    return tsp.relax(labels, data, [tsp.FeatureSpec(*s) for s in specs], num, ITERS, 0.5, DIAG,
                     phases=phases, stats_refresh=stats_refresh, **kw)


@pytest.mark.parametrize("phases,stats_refresh,layout", [
    (1, "frame", "flagship"), (2, "frame", "flagship"), (1, "phase", "flagship"),
    (2, "phase", "flagship"), (2, "frame", "progressive"), (2, "phase", "progressive"),
    (1, "phase", "grayscale"), (2, "frame", "grayscale"),
])
def test_relax_matches_jax(phases, stats_refresh, layout):
    want = _jax_relax(layout, phases, stats_refresh)
    kbuild.reset_counts()
    got = _port_relax(layout, phases, stats_refresh).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != _relax_inputs(layout)[0]).sum() > 20  # the sweeps moved labels
    # The wrappers' calls: one sweep call in 'frame' mode; in 'phase' mode one
    # K3 sub-step and one K2 tally per sub-step (the last re-tally skipped).
    k2 = kbuild.COUNTERS["moment_tally"].plain_calls
    if stats_refresh == "frame":
        assert (krelax.COUNTER.plain_calls, k2) == (1, 1)
    else:
        steps = krelax.launches(ITERS, phases, "phase")
        assert steps == ITERS * phases
        assert (krelax.COUNTER.plain_calls, k2) == (steps, steps)


@pytest.mark.parametrize("phases,layout", [(1, "flagship"), (2, "progressive")])
def test_spatial_phase_mode_matches_jax_unsharded(phases, layout):
    """4 shards of 12 rows with iterations x phases-row halos (-1 beyond the
    frame), 'phase' statistics psum'd after every sub-step: the core rows
    equal JAX's unsharded op.  Shard 0's halo starts above the frame, so its
    checkerboard rows start negative."""
    want = _jax_relax(layout, phases, "phase")
    labels, data, specs, _ = _relax_inputs(layout)
    n, halo = 4, ITERS * phases
    hl = RH // n
    assert halo <= hl
    group = ShardGroup(n, ["cpu"] * n)
    sp = SpatialContext(group, hl)

    def shard(i):
        lab = sp.exchange(torch.from_numpy(labels[i * hl:(i + 1) * hl].copy()), halo, halo,
                          fill=-1)
        ext = [sp.exchange(torch.from_numpy(d[i * hl:(i + 1) * hl].copy()), halo, halo)
               for d in data]
        out = _port_relax(layout, phases, "phase", labels=lab, data=ext,
                          row_offset=sp.row0 - halo, global_h=RH, halo_rows=(halo, halo),
                          psum=sp.psum)
        return out[halo:halo + hl]

    np.testing.assert_array_equal(torch.cat(group.run(shard)).numpy(), want)


def test_superpixel_spatial_halo_must_fit_the_shard():
    """The halo is iterations x phases rows: the flagship's 24 initial sweeps
    with two phases need 48 rows, more than the spatial config's 47-row
    shards (the JAX module raises the same way)."""
    mods = [{"type": "superpixels", "initial_iterations": 24, "iterations": 8,
             "relax_phases": 2, "stats_refresh": "phase", "disparity_weight": 0}]
    src = {"type": "synthetic", "image_size": [376, 64], "num_frames": 1}
    with pytest.raises(ValueError, match="initial_iterations\\*phases=48 exceeds the 47-row"):
        build_pipeline(src, mods, device="cpu", parallel={"mode": "spatial", "devices": 8})
    pipe, _ = build_pipeline(src, [dict(mods[0], relax_phases=1)], device="cpu",
                             parallel={"mode": "spatial", "devices": 8})
    assert pipe.modules[0].stats_refresh == "phase"


# ------------------------------------------------------- temporal vote ops


@pytest.mark.parametrize("num_prev", [0, 1, 3])
@pytest.mark.parametrize("weight,compare_unknown", [(2, True), (1, False)])
def test_temporal_vote_matches_jax(weight, compare_unknown, num_prev):
    k, h, w = 3, 24, 40
    rng = np.random.default_rng(10 * num_prev + weight)
    current = rng.integers(0, 3, (h, w)).astype(np.uint8)
    prev = rng.integers(0, 3, (k, h, w)).astype(np.uint8)
    # S10.5 flow up to +-12 px with fractions: chains leave the frame.
    flows = rng.integers(-12 * 32, 12 * 32, (k, h, w, 2)).astype(np.int16)
    want = jps.temporal_vote(jnp.asarray(current), jnp.asarray(prev), jnp.asarray(flows),
                             jnp.int32(num_prev), weight, compare_unknown)
    got = tps.temporal_vote(torch.from_numpy(current), torch.from_numpy(prev),
                            torch.from_numpy(flows), num_prev, weight, compare_unknown)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jx, jy, jinb = jps._warp_coords(jnp.asarray(flows), jnp.int32(num_prev))
    tx, ty, tinb = tps.warp_coords(torch.from_numpy(flows), num_prev)
    for a, b in ((tx, jx), (ty, jy), (tinb, jinb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < tinb[:num_prev].float().mean() < 1 if num_prev else not tinb.any()


def test_planeseg_derivative_matches_jax():
    rng = np.random.default_rng(3)
    h, w = 40, 56
    # Smooth disparities (x16) with invalid runs and a few jumps.
    disp = (np.linspace(200, 1400, h)[:, None] + rng.integers(-40, 40, (h, w))).astype(np.int16)
    disp[rng.random((h, w)) < 0.15] = -32768
    disp[5:9, 10:30] = -32768
    disp[20, :] = 3000
    want_d, want_h = jder.planeseg_derivative(jnp.asarray(disp))
    got_d, got_h = tder.planeseg_derivative(torch.from_numpy(disp))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert got_h.sum() > h * w // 2 and (got_d == -32768).any()


# -------------------------------------------------- the faithful flagship

H, W, D, FRAMES, RESUME_AFTER = 64, 128, 32, 6, 3


def _source():
    return SyntheticDataSource(image_size=(H, W), num_frames=FRAMES, seed=0,
                               max_disparity=0.7 * D, baseline=20.0)


def _flagship(M, provider):
    """The six flagship modules with configs/kitti-planeseg.json's order and
    the reference-faithful knobs: 'phase' statistics, two relax phases, the
    faithful temporal vote."""
    sp = M.SuperPixelModule((H, W), initial_iterations=3, iterations=2, block_size=8,
                            reset_iterations=4, relax_phases=2, stats_refresh="phase")
    return [
        sp,
        M.ImageOpticalFlowModule((H, W)),
        M.ImageDisparityModule((H, W), min_disparity=4, num_disparities=D,
                               smoothing_radius=2, smoothing_iterations=1),
        M.ImageDisparityDerivativeModule(),
        M.DepthModule(),
        M.SuperPixelDisparityPlaneSegmentationModule(provider, num_labels=sp.num_labels,
                                                     update_interval=3,
                                                     use_temporal_smoothing=True,
                                                     temporal_mode="faithful"),
    ]


def _jax_run(modules):
    """The JAX run of `modules`: frames, per-frame (outputs, state, host
    params), and (state, host params, host state) after RESUME_AFTER."""
    src = _source()
    pipe = JPipeline(JContext(height=H, width=W, q=src.get_camera_intrinsics().q), modules)
    state, params = pipe.init_state(), pipe.init_host_params()
    frames, record, resume = [], [], None
    for fid in range(1, FRAMES + 1):
        f = src.get_next()
        frames.append(f)
        state, out = pipe.make_step(pipe.variant(fid))(state, {**f, "frame_id": np.int32(fid)},
                                                       params)
        out = {k: np.asarray(v) for k, v in out.items()}
        for m in pipe.modules:
            keys = m.host_fetch_keys()
            if keys:
                upd = m.host_update(pipe.ctx, fid, {k: out[k] for k in keys})
                if upd:
                    params[m.name] = {**params[m.name], **upd}
        state_np = jax.tree.map(np.asarray, state)
        record.append((out, state_np, {k: dict(v) for k, v in params.items()}))
        if fid == RESUME_AFTER:
            resume = (state_np, {k: dict(v) for k, v in params.items()},
                      pipe.modules[-1].host_state())
    return frames, record, resume


def _run_port(modules, frames, record, first=1, resume=None):
    pipe = Pipeline(PipelineContext(height=H, width=W, q=_source().get_camera_intrinsics().q,
                                    device="cpu"), modules)
    state, params = pipe.init_state(), pipe.init_host_params()
    if resume is not None:
        state_np, params, host_state = resume
        pipe.modules[-1].restore_host_state(host_state)
        state = state_from_reference(state_np, "cpu")
    for fid in range(first, FRAMES + 1):
        state, out = pipe.step(state, frame_to_device(frames[fid - 1], fid, "cpu"), params,
                               pipe.variant(fid))
        params = host_step(pipe, fid, out, params)
        ref_out, ref_state, ref_params = record[fid - 1]
        _assert_tree_equal(state_to_numpy(out), ref_out, f"frame {fid} outputs")
        _assert_tree_equal(state_to_numpy(state), ref_state, f"frame {fid} state")
        _assert_tree_equal(params, ref_params, f"frame {fid} host params")
    return state, out


@pytest.fixture(scope="module")
def faithful_reference():
    return _jax_run(_flagship(jm, JProvider()))


def test_faithful_flagship_matches_jax_every_frame(faithful_reference):
    frames, record, _ = faithful_reference
    kbuild.reset_counts()
    state, out = _run_port(_flagship(tm, TProvider()), frames, record)
    # The faithful vote keeps no accumulator: the history rings carry it.
    assert state["modules"]["SPPlaneSegmentation"] == {}
    assert state["history"]["optflow"].shape == (2, H, W, 2)
    assert state["history"]["planes_unsmoothed"].shape == (3, H, W)
    assert (out["planes"] != out["planes_unsmoothed"]).any()
    # Frames 1 and 4 run 3 sweeps, the others 2, each of 2 sub-steps: one K3
    # call and one K2 tally per sub-step.
    steps = sum(krelax.launches(3 if fid in (1, 4) else 2, 2, "phase")
                for fid in range(1, FRAMES + 1))
    assert krelax.COUNTER.plain_calls == steps
    assert kbuild.COUNTERS["moment_tally"].plain_calls == steps


def test_faithful_flagship_resumes_from_jax_state(faithful_reference):
    frames, record, resume = faithful_reference
    _run_port(_flagship(tm, TProvider()), frames, record, RESUME_AFTER + 1, resume)


