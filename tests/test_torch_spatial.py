"""The port's height-sharded spatial mode against the JAX package, on the CPU.

The port runs its row shards as threads of one process (parallel/group.py);
each shard's kernels take their plain versions on CPU tensors.  Held here:

  * the sharded SGM (K5's plain route, parallel/sgm_sharded.py) for 1, 3 and
    8 shards at 48x128 (8 shards of 6 rows are below the census and SGM
    reach), bit-equal to the JAX full-frame op, and for 3 shards to the JAX
    sharded op under a 3-device shard_map;
  * the settle and output sweeps from a random carry, against a JAX
    ``lax.scan`` of ``stereo.sgm_scan_step``;
  * the 8-shard SpatialPipeline at 96x128, 4 frames through a reset, against
    the JAX production Pipeline at the parameters of
    tests/test_spatial_flagship.py: every output equal (depth within
    rtol 1e-5, atol 1e-4, the JAX test's bound for XLA's fusions), and with
    the 'sharded' flow the flow equal to the JAX ``dense_flow`` of each
    shard's edge-padded apron rows, cropped, and the planes within the JAX
    test's 0.98 agreement gate;
  * the config path, the per-module rejection, the shard group's collectives
    and its failure modes.

No JAX whole-pipeline shard_map runs here: the JAX reference is the
full-frame Pipeline, and the JAX spatial mode has its own tests.
"""

import functools
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cartslam_tpu import models as jm
from cartslam_tpu.ops import color as jcolor
from cartslam_tpu.ops import optflow as jfops
from cartslam_tpu.ops import stereo as jstereo
from cartslam_tpu.parallel.sgm_sharded import sgm_disparity_sharded as jsharded
from cartslam_tpu.runtime.module import PipelineContext as JContext
from cartslam_tpu.runtime.pipeline import Pipeline as JPipeline
from cartslam_tpu.sources.synthetic import SyntheticDataSource
from cartslam_tpu.utils.plane_params import StaticPlaneParameterProvider as JStatic
from cartslam_tpu_torch import models as tm
from cartslam_tpu_torch.config import build_pipeline, build_system, read_config
from cartslam_tpu_torch.kernels import build as kbuild
from cartslam_tpu_torch.kernels import sgm as ksgm
from cartslam_tpu_torch.ops import stereo as tstereo
from cartslam_tpu_torch.parallel.group import CollectiveTimeout, ShardGroup
from cartslam_tpu_torch.parallel.halo import exchange_row_halo
from cartslam_tpu_torch.parallel.sgm_sharded import sgm_disparity_sharded
from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
from cartslam_tpu_torch.runtime import Module, PipelineContext, run, state_to_numpy
from cartslam_tpu_torch.runtime.loop import frame_to_device
from cartslam_tpu_torch.runtime.module import SpatialContext
from cartslam_tpu_torch.utils.plane_params import StaticPlaneParameterProvider as TStatic

SGM_KW = dict(min_disparity=1, num_disparities=32, p1=10, p2=120, uniqueness=12)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The shard threads run their ops on one intra-op thread
    (parallel/group.py); the full-frame port runs here do the same, so the
    file's time does not hang on the machine's load (an 8-thread pool on
    busy cores made a 5-frame 48x64 full-frame run take 90 s, not 1.5)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _group(n, h):
    group = ShardGroup(n, ["cpu"] * n)
    return group, SpatialContext(group, h // n)


def _rows(x: np.ndarray, i: int, n: int) -> torch.Tensor:
    h = x.shape[0] // n
    return torch.from_numpy(x[i * h:(i + 1) * h].copy())


@pytest.fixture(scope="module")
def stereo_pair():
    src = SyntheticDataSource(image_size=(48, 128), num_frames=1, seed=0,
                              max_disparity=20.0, baseline=8.0)
    f = src.get_next()
    to_gray = jax.jit(jcolor.bgr_to_gray)
    gl, gr = np.asarray(to_gray(f["left"])), np.asarray(to_gray(f["right"]))
    want = np.asarray(jax.jit(functools.partial(jstereo.sgm_disparity, backend="xla",
                                                **SGM_KW))(gl, gr))
    return gl, gr, want


# ------------------------------------------------------------ sharded SGM


@pytest.mark.parametrize("n", [1, 3, 8])
def test_sgm_sharded_matches_jax_full_frame(stereo_pair, n):
    gl, gr, want = stereo_pair
    group, sp = _group(n, gl.shape[0])
    kbuild.reset_counts()
    got = group.run(lambda i: sgm_disparity_sharded(_rows(gl, i, n), _rows(gr, i, n), sp,
                                                    **SGM_KW))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want, err_msg=f"{n} shards")
    assert ksgm.SHARDED_COUNTER.plain_calls == n and ksgm.SHARDED_COUNTER.launches == 0


def test_sgm_sharded_matches_jax_sharded_op(stereo_pair):
    """3 shards against the JAX sharded op itself (XLA route) under a
    3-device shard_map."""
    gl, gr, _ = stereo_pair
    n, ax = 3, "spatial"
    mesh = Mesh(np.array(jax.devices()[:n]), (ax,))
    shard = NamedSharding(mesh, P(ax))
    fn = jax.jit(jax.shard_map(functools.partial(jsharded, axis_name=ax, backend="xla",
                                                 **SGM_KW),
                               mesh=mesh, in_specs=(P(ax), P(ax)), out_specs=P(ax)))
    want = np.asarray(fn(jax.device_put(gl, shard), jax.device_put(gr, shard)))
    group, sp = _group(n, gl.shape[0])
    got = group.run(lambda i: sgm_disparity_sharded(_rows(gl, i, n), _rows(gr, i, n), sp,
                                                    **SGM_KW))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
def test_sweeps_from_a_carry_match_jax_scan(reverse):
    """The output sweep (every step) and the settle sweep (its final carry)
    from a random int32 carry, against lax.scan of sgm_scan_step; then one
    plain settle round of K5 (sgm_vcarry_plain) on census words against the
    JAX cost volume scanned from the same carries."""
    rng = np.random.default_rng(3)
    p1, p2 = 10, 120
    cost = rng.integers(0, 63, (12, 40, 32)).astype(np.uint8)
    carry = rng.integers(0, 300, (40, 32)).astype(np.int32)
    xs = cost[::-1] if reverse else cost
    fin, ys = jax.lax.scan(jstereo.sgm_scan_step(p1, p2), jax.numpy.asarray(carry), xs)
    out = tstereo._aggregate_scan(torch.from_numpy(xs.copy()), p1, p2, torch.from_numpy(carry))
    np.testing.assert_array_equal(out.numpy().astype(np.int16), np.asarray(ys))
    np.testing.assert_array_equal(out[-1].numpy(), np.asarray(fin))

    cl = [rng.integers(0, 2**31 - 1, (12, 40), dtype=np.int32) for _ in range(4)]
    jcost = np.asarray(jstereo.hamming_cost_volume((cl[0], cl[1]), (cl[2], cl[3]), 2, 32))
    chwd = np.transpose(jcost, (1, 2, 0))  # [h, W, D]
    tb, bt = (rng.integers(0, 300, (40, 32)).astype(np.int32) for _ in range(2))
    step = jstereo.sgm_scan_step(p1, p2)
    want_tb, _ = jax.lax.scan(step, jax.numpy.asarray(tb), chwd)
    want_bt, _ = jax.lax.scan(step, jax.numpy.asarray(bt), chwd[::-1])
    got_tb, got_bt = ksgm.sgm_vcarry_plain(*map(torch.from_numpy, cl), torch.from_numpy(tb),
                                           torch.from_numpy(bt), min_disparity=2,
                                           num_disparities=32, p1=p1, p2=p2)
    np.testing.assert_array_equal(got_tb.numpy(), np.asarray(want_tb))
    np.testing.assert_array_equal(got_bt.numpy(), np.asarray(want_bt))


def test_sgm_sharded_wrapper_raises_on_uint8_overflow_params():
    """K5 keeps K1's uint8 path storage: p2 above 193 is refused on the card
    (checked before any launch, so it raises here too)."""
    with pytest.raises(ValueError, match="p2 <= 193"):
        ksgm._check_k1_params(200, 32)


# ------------------------------------------------------- the whole mode

H, W, FRAMES = 96, 128, 4  # 8 shards of 12 rows
CFG = dict(num_disparities=32, min_disparity=1, block_size=8, iterations=4,
           initial_iterations=6, reset_iterations=4, max_warp_y=8, flow_levels=3,
           flow_search=2, flow_refine=1, flow_base_level=1, flow_halo=12)
RANGES = ((3, 40), (-6, 3))
FETCH = ("disparity", "disparity_derivative_histogram", "superpixels", "planes",
         "planes_unsmoothed", "depth", "optflow")


def _q():
    q = np.eye(4, dtype=np.float32)
    q[2, 2], q[2, 3] = 0.0, 120.0
    q[3, 2], q[3, 3] = 2.0, 0.0
    return q


def _modules(M, static, flow_kw=None):
    c = CFG
    sup = M.SuperPixelModule((H, W), initial_iterations=c["initial_iterations"],
                             iterations=c["iterations"], block_size=c["block_size"],
                             reset_iterations=c["reset_iterations"])
    return [
        M.ImageDisparityModule((H, W), min_disparity=c["min_disparity"],
                               num_disparities=c["num_disparities"], smoothing_radius=2,
                               smoothing_iterations=1),
        M.ImageDisparityDerivativeModule(),
        M.DepthModule(),
        sup,
        M.ImageOpticalFlowModule((H, W), levels=c["flow_levels"], search=c["flow_search"],
                                 refine=c["flow_refine"], base_level=c["flow_base_level"],
                                 **(flow_kw or {})),
        M.SuperPixelDisparityPlaneSegmentationModule(
            static(*RANGES), num_labels=sup.num_labels, use_temporal_smoothing=True,
            temporal_smoothing_distance=3, warp_mode="select", max_warp_y=c["max_warp_y"],
            max_warp_x=64),
    ]


@pytest.fixture(scope="module")
def frames():
    src = SyntheticDataSource(image_size=(H, W), num_frames=FRAMES, seed=0)
    return [src.get_next() for _ in range(FRAMES)]


@pytest.fixture(scope="module")
def jax_reference(frames):
    """The JAX production Pipeline (full frame, 'select' warp), as
    tests/test_spatial_flagship.py builds it."""
    pipe = JPipeline(JContext(height=H, width=W, q=_q()), _modules(jm, JStatic))
    state, hp = jax.device_put(pipe.init_state()), pipe.init_host_params()
    outs = []
    for i, f in enumerate(frames):
        step = pipe.jitted_step(pipe.variant(i + 1), frozenset(FETCH))
        state, out = step(state, {"left": f["left"], "right": f["right"],
                                  "frame_id": np.int32(i + 1)}, hp)
        outs.append(jax.device_get(out))
    return outs


def _jax_apron_flow(frames, fid, n):
    """The 'sharded' flow mode's output from the JAX package: dense_flow on
    each shard's rows with spatial_halo edge-padded apron rows (the halo
    exchange's 'edge' fill at the frame's edges), cropped to the shard."""
    if fid == 1:
        return np.zeros((H, W, 2), np.int16)
    hl, fh = H // n, CFG["flow_halo"]
    to_gray = jax.jit(jcolor.bgr_to_gray)
    cur, prev = (np.asarray(to_gray(frames[k]["left"])) for k in (fid - 1, fid - 2))
    flow = jax.jit(functools.partial(jfops.dense_flow, levels=CFG["flow_levels"],
                                     search=CFG["flow_search"], refine=CFG["flow_refine"],
                                     base_level=CFG["flow_base_level"]))
    out = []
    for i in range(n):
        rows = np.clip(np.arange(i * hl - fh, (i + 1) * hl + fh), 0, H - 1)
        ext = np.asarray(jfops.to_s10_5(flow(cur[rows], prev[rows])))
        out.append(ext[fh:fh + hl])
    return np.concatenate(out)


@pytest.mark.parametrize("flow_mode", ["global", "sharded"])
def test_spatial_pipeline_matches_jax_pipeline(frames, jax_reference, flow_mode):
    flow_kw = dict(spatial_mode=flow_mode, spatial_halo=CFG["flow_halo"])
    pipe = SpatialPipeline(PipelineContext(height=H, width=W, q=_q(), device="cpu"),
                           _modules(tm, TStatic, flow_kw), 8)
    state, hp = pipe.init_state(), pipe.init_host_params()
    names = [m.name for m in pipe.modules]
    assert [dict(zip(names, pipe.variant(i)))["SuperPixelDetect"] for i in range(1, 5)] == [
        "initial", "normal", "normal", "reset"]
    for i, (f, want) in enumerate(zip(frames, jax_reference)):
        fid = i + 1
        state, out = pipe.step(state, frame_to_device(f, fid, "cpu"), hp, pipe.variant(fid))
        got = state_to_numpy(out)
        for key in ("disparity", "disparity_derivative_histogram", "superpixels",
                    "planes_unsmoothed"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"frame {fid} {key}")
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-5, atol=1e-4)
        if flow_mode == "global":
            np.testing.assert_array_equal(got["optflow"], want["optflow"],
                                          err_msg=f"frame {fid}")
            np.testing.assert_array_equal(got["planes"], want["planes"], err_msg=f"frame {fid}")
        else:
            np.testing.assert_array_equal(got["optflow"], _jax_apron_flow(frames, fid, 8),
                                          err_msg=f"frame {fid}")
            assert fid == 1 or (got["optflow"] != 0).any()
            # Per-shard pyramids shift their decimation grids: the sharded
            # flow mode's documented approximation of the full frame.
            agree = (got["planes"] == want["planes"]).mean()
            assert agree > 0.98, (fid, agree)
    # The carried state is full height, the vote stack split at its row axis.
    votes = state["modules"]["SPPlaneSegmentation"]["warp_votes"]
    assert votes.shape == (3, H, W) and (votes != 3).any()


def test_spatial_config_runs_through_the_loop(tmp_path):
    """`parallel.mode: "spatial"` through read_config and runtime/loop.run,
    5 frames with the histogram-peak provider (updates at 1, 3, 5) and a
    reset at frame 4, equal frame by frame to the full-frame port with the
    'select' warp."""
    h, w = 48, 64
    mods = [
        {"type": "disparity", "num_disparities": 16, "min_disparity": 1,
         "smoothing_radius": 2, "smoothing_iterations": 1},
        {"type": "disparity_derivative"},
        {"type": "depth"},
        {"type": "optflow", "levels": 3, "search": 2, "refine": 1},
        {"type": "superpixels", "block_size": 8, "iterations": 4, "initial_iterations": 6,
         "reset_iterations": 4},
        {"type": "superpixel_disparity_planeseg",
         "parameter_provider": {"type": "histogram_peak"}, "update_interval": 2,
         "use_temporal_smoothing": True, "max_warp_y": 8},
    ]
    src = {"type": "synthetic", "image_size": [h, w], "num_frames": 5}
    path = tmp_path / "spatial.json"
    path.write_text(json.dumps({"data_source": src, "modules": mods,
                                "parallel": {"mode": "spatial", "devices": 4}}))
    pipe, source = read_config(str(path), device="cpu")
    assert isinstance(pipe, SpatialPipeline) and pipe.n == 4 and pipe.h_local == 12
    seen = []
    res = run(pipe, source, on_frame=lambda fid, out: seen.append(state_to_numpy(out)))
    assert res.frames == 5 and seen[-1]["planes"].shape == (h, w)
    seg = pipe.modules[-1]
    assert seg._running is not None and res.host_params[seg.name]["ranges"].shape == (2, 2)

    full_mods = [dict(m, warp_mode="select") if m["type"].endswith("planeseg") else m
                 for m in mods]
    ref, ref_source = build_pipeline(src, full_mods, device="cpu")
    want = []
    ref_res = run(ref, ref_source, on_frame=lambda fid, out: want.append(state_to_numpy(out)))
    for fid, (a, b) in enumerate(zip(seen, want), start=1):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"frame {fid} {k}")
    for name, params in ref_res.host_params.items():
        for k, v in params.items():
            np.testing.assert_array_equal(res.host_params[name][k], v)


def test_spatial_registry_knobs_and_refusals():
    src = {"type": "synthetic", "image_size": [48, 64], "num_frames": 1}
    mods = [{"type": "disparity", "num_disparities": 16}, {"type": "optflow"}]
    pipe, _ = build_pipeline(src, mods, device="cpu",
                             parallel={"mode": "spatial", "devices": 4, "flow_mode": "sharded"})
    flow = pipe.modules[-1]
    assert flow.spatial_mode == "sharded" and flow.spatial_halo == 12  # clamped to h_local
    with pytest.raises(ValueError, match="must divide"):
        build_pipeline(src, mods, device="cpu", parallel={"mode": "spatial", "devices": 5})
    # The multi-sequence modes drive B sources, which only a System does:
    # build_pipeline refuses them, build_system builds them, the composed
    # mode with devices // sequences shards a sequence.
    composed = {"mode": "spatial", "devices": 4, "sequences": 2, "flow_mode": "sharded"}
    for parallel in ({"batch": 2}, composed):
        with pytest.raises(ValueError, match="multi-sequence modes .* use build_system"):
            build_pipeline(src, mods, device="cpu", parallel=parallel)
    system = build_system(src, mods, device="cpu", parallel=composed)
    assert system.batch == 2 and system.pipeline.n == 2
    assert system.pipeline.modules[-1].spatial_halo == 24  # clamped to a sequence's shard
    with pytest.raises(ValueError, match="must divide by sequences"):
        build_system(src, mods, device="cpu",
                     parallel={"mode": "spatial", "devices": 3, "sequences": 2})
    with pytest.raises(ValueError, match="unknown parallel mode"):
        build_pipeline(src, mods, device="cpu", parallel={"mode": "pipeline"})


def test_spatial_rejects_modules_without_compute_spatial():
    class FullFrameOnly(Module):
        name = "FullFrameOnly"

        def provides(self):
            return ["thing"]

        def compute(self, ctx, step, deps, state, params, variant):
            return {"thing": torch.zeros(())}, {}

    ctx = PipelineContext(height=48, width=64, q=np.eye(4, dtype=np.float32), device="cpu")
    with pytest.raises(ValueError, match="FullFrameOnly does not support the spatial latency "
                                         r"mode \(no compute_spatial\)"):
        SpatialPipeline(ctx, [tm.ImageDisparityModule((48, 64), num_disparities=16),
                              FullFrameOnly()], 4)


def test_psummed_stat_table_is_rounded_once():
    """init_stats' psum hook sums the shards' exact int64 tables before the
    one float32 rounding, so the sharded table equals the full frame's even
    where entries pass 2^24 (a psum of the rounded tables would not)."""
    from cartslam_tpu_torch.ops.superpixels import init_stats
    from cartslam_tpu_torch.ops.tally import table_gather

    rng = np.random.default_rng(5)
    n, hl, w, num = 4, 6, 16, 5
    labels = rng.integers(0, num, (n * hl, w)).astype(np.int32)
    data = rng.integers(-32768, 32768, (3, n * hl, w)).astype(np.float32)
    for channels in (3, 9):  # K2's route, and K7's above 8 channels
        d = np.concatenate([data] * (channels // 3))
        full = init_stats(torch.from_numpy(labels), torch.from_numpy(d), num)
        group, sp = _group(n, n * hl)
        parts = group.run(lambda i: (
            init_stats(_rows(labels, i, n), torch.from_numpy(d[:, i * hl:(i + 1) * hl].copy()),
                       num, psum=sp.psum),
            init_stats(_rows(labels, i, n), torch.from_numpy(d[:, i * hl:(i + 1) * hl].copy()),
                       num)))
        for exact, _ in parts:
            assert torch.equal(exact, full)
        rounded = sum(p[1] for p in parts)
        assert not torch.equal(rounded, full)  # the entries here pass 2^24
    # Out-of-range labels (the -1 halo fill) gather zeros, not the last label.
    table = torch.arange(10, dtype=torch.float32).reshape(2, 5) + 1
    got = table_gather(table, torch.tensor([[0, -1], [4, 5]]))
    assert got.tolist() == [[[1.0, 0.0], [5.0, 0.0]], [[6.0, 0.0], [10.0, 0.0]]]


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_relax_sweeps_on_shard_rows_match_full_frame(shard):
    """K3's entry (its plain version here) on one shard's rows with
    `iterations`-row label halos, -1 beyond the frame, the global table and
    the global rows' progressive factor: its core rows equal the same rows
    of the full-frame call, and the -1 rows stay -1."""
    from cartslam_tpu_torch.kernels import relax as krelax
    from cartslam_tpu_torch.ops.superpixels import block_init_labels, init_stats

    n, hl, w, k = 4, 8, 40, 3
    h = n * hl
    rng = np.random.default_rng(shard)
    labels, num = block_init_labels(h, w, 6, 6)
    num += 1
    img = torch.from_numpy(np.clip(rng.normal(128, 40, (5, h, w)), 0, 255).round()
                           .astype(np.float32))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    data = torch.cat([img, xs[None], ys[None]]).contiguous()
    table = init_stats(labels, data, num)
    feats = [krelax.RelaxFeature("gaussian", 0, 2, 1.0), krelax.RelaxFeature("gaussian", 2, 3, 1.5),
             krelax.RelaxFeature("compactness", 5, 2, 0.1)]
    gh = torch.tensor(float(h))
    prog_of = lambda rows: 1.0 + 0.5 * (gh - rows) / gh
    full = krelax.relax_sweeps(labels, table, data, feats, 7, k, 0.5, 0.5 / np.sqrt(2),
                               prog_of(torch.arange(h, dtype=torch.float32)))
    assert not torch.equal(full, labels)

    rows = torch.arange(shard * hl - k, (shard + 1) * hl + k)
    inside = (rows >= 0) & (rows < h)
    src = rows.clamp(0, h - 1)
    lab_ext = torch.where(inside[:, None], labels[src], -1).contiguous()
    data_ext = torch.where(inside[None, :, None], data[:, src], 0.0).contiguous()
    out = krelax.relax_sweeps(lab_ext, table, data_ext, feats, 7, k, 0.5, 0.5 / np.sqrt(2),
                              prog_of(rows.to(torch.float32)))
    assert torch.equal(out[k:k + hl], full[shard * hl:(shard + 1) * hl])
    assert (out[~inside] == -1).all()


# --------------------------------------------------------- the shard group


def test_group_collectives_and_halo():
    n, hl = 4, 3
    x = np.arange(n * hl * 2, dtype=np.int32).reshape(n * hl, 2)
    group, sp = _group(n, n * hl)
    fwd = [(i, i + 1) for i in range(n - 1)]

    def shard(i):
        xi = _rows(x, i, n)
        return (group.axis_index(), group.ppermute(xi, fwd), group.psum(xi),
                group.all_gather_rows(xi), exchange_row_halo(xi, 2, 1, group),
                exchange_row_halo(xi, 1, 2, group, fill=-1), sp.row0, sp.slice_rows(
                    torch.from_numpy(x)))

    for i, (idx, perm, total, full, edge, const, row0, rows) in enumerate(group.run(shard)):
        assert idx == i and row0 == i * hl
        want_perm = x[(i - 1) * hl:i * hl] if i else np.zeros((hl, 2), np.int32)
        np.testing.assert_array_equal(perm.numpy(), want_perm)
        np.testing.assert_array_equal(total.numpy(), x.reshape(n, hl, 2).sum(0))
        np.testing.assert_array_equal(full.numpy(), x)
        np.testing.assert_array_equal(rows.numpy(), x[i * hl:(i + 1) * hl])
        pad_edge = x[np.clip(np.arange(i * hl - 2, (i + 1) * hl + 1), 0, n * hl - 1)]
        np.testing.assert_array_equal(edge.numpy(), pad_edge)
        idx_c = np.arange(i * hl - 1, (i + 1) * hl + 2)
        inb = (idx_c >= 0) & (idx_c < n * hl)
        want_c = np.where(inb[:, None], x[np.clip(idx_c, 0, n * hl - 1)], -1)
        np.testing.assert_array_equal(const.numpy(), want_c)


def test_group_reraises_a_shard_exception_without_hanging():
    group = ShardGroup(8, ["cpu"] * 8)

    def shard(i):
        if i == 3:
            raise KeyError("shard 3 failed")
        return group.psum(torch.ones(2))  # the others wait here for shard 3

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="shard 3 failed"):
        group.run(shard)
    assert time.monotonic() - t0 < 5.0
    assert not [t for t in threading.enumerate() if t.name.startswith("shard-")]
    # The group is usable again after a failure.
    assert [int(t.sum()) for t in group.run(lambda i: group.psum(torch.ones(2)))] == [16] * 8


def test_group_times_out_when_a_shard_skips_a_collective():
    group = ShardGroup(2, ["cpu"] * 2, timeout=0.5)
    with pytest.raises(CollectiveTimeout):
        group.run(lambda i: group.psum(torch.ones(1)) if i == 0 else None)
