"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through the JAX function (its
XLA path, as the JAX package's own CPU tests run it) and through the port's
function on CPU tensors, where every kernel wrapper takes its plain version.
Tolerances are stated per test; integer outputs must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartslam_tpu.ops import color as jcolor
from cartslam_tpu.ops import depth as jdepth
from cartslam_tpu.ops import derivative as jderiv
from cartslam_tpu.ops import disparity as jdisp
from cartslam_tpu.ops import planeseg as jplane
from cartslam_tpu.ops import stereo as jstereo
from cartslam_tpu.ops import superpixels as jsp
from cartslam_tpu.ops import tally as jtally
from cartslam_tpu.ops import warp as jwarp
from cartslam_tpu_torch.kernels import build
from cartslam_tpu_torch.kernels import relax as krelax
from cartslam_tpu_torch.kernels import sgm as ksgm
from cartslam_tpu_torch.kernels import tally as ktally
from cartslam_tpu_torch.ops import color as tcolor
from cartslam_tpu_torch.ops import depth as tdepth
from cartslam_tpu_torch.ops import derivative as tderiv
from cartslam_tpu_torch.ops import disparity as tdisp
from cartslam_tpu_torch.ops import planeseg as tplane
from cartslam_tpu_torch.ops import stereo as tstereo
from cartslam_tpu_torch.ops import superpixels as tsp
from cartslam_tpu_torch.ops import tally as ttally
from cartslam_tpu_torch.ops import warp as twarp


def t(a):
    return torch.from_numpy(np.array(a))


def stereo_pair(h, w, d, seed=0):
    """Random texture with a disparity step, as a gray uint8 pair."""
    rng = np.random.RandomState(seed)
    tex = rng.randint(0, 255, (h, w + 2 * d + 8)).astype(np.uint8)
    left = tex[:, :w].copy()
    right = tex[:, d : d + w].copy()
    right[:, w // 2 :] = tex[:, 2 * d + w // 2 : 2 * d + w]
    return left, right


def sample_disparity(h, w, seed=0):
    """int16 x16 disparities with invalid (-32768) holes."""
    rng = np.random.RandomState(seed)
    d = rng.randint(0, 900, (h, w)).astype(np.int16)
    d[rng.rand(h, w) < 0.15] = -32768
    return d


# ----------------------------------------------------------------- color


@pytest.mark.parametrize("fn", ["bgr_to_gray", "bgr_to_ycrcb"])
def test_color_matches_jax(fn):
    """Exact (uint8 equal) against the JAX op called eagerly."""
    img = np.random.RandomState(3).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    ref = np.asarray(getattr(jcolor, fn)(jnp.asarray(img)))
    out = getattr(tcolor, fn)(t(img)).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------- stereo


def test_census_matches_jax():
    gray = np.random.RandomState(4).randint(0, 256, (19, 33)).astype(np.uint8)
    r0, r1 = jstereo.census_transform(jnp.asarray(gray))
    o0, o1 = tstereo.census_transform(t(gray))
    np.testing.assert_array_equal(o0.numpy(), np.asarray(r0))
    np.testing.assert_array_equal(o1.numpy(), np.asarray(r1))


SGM_CASES = [
    dict(num_disparities=16, min_disparity=0, lr_check=True),
    dict(num_disparities=16, min_disparity=4, lr_check=False),
    dict(num_disparities=32, min_disparity=0, lr_check=False),
    dict(num_disparities=32, min_disparity=4, lr_check=True),
    dict(num_disparities=16, min_disparity=2, p1=7, p2=86),
    dict(num_disparities=16, min_disparity=0, uniqueness=5),
    dict(num_disparities=16, min_disparity=0, uniqueness=30, subpixel=False),
]


@pytest.mark.parametrize("kw", SGM_CASES, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_sgm_matches_jax_xla(kw):
    """int16 disparity array_equal at an odd width (24x61)."""
    left, right = stereo_pair(24, 61, 6, seed=sum(kw.values()) % 7)
    ref = np.asarray(jstereo.sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                                           backend="xla", **kw))
    before = ksgm.COUNTER.plain_calls
    out = tstereo.sgm_disparity(t(left), t(right), **kw).numpy()
    assert ksgm.COUNTER.plain_calls == before + 1  # CPU tensors -> plain version
    assert out.dtype == np.int16
    assert (ref != jstereo.DISPARITY_INVALID).mean() > 0.3
    np.testing.assert_array_equal(out, ref)


def test_sgm_aggregate_matches_jax():
    """The plain 4-path volume equals the XLA path's, exactly."""
    left, right = stereo_pair(12, 29, 4)
    jl, jr = jstereo.census_transform(jnp.asarray(left)), jstereo.census_transform(jnp.asarray(right))
    ref = np.asarray(jstereo.sgm_aggregate(jstereo.hamming_cost_volume(jl, jr, 1, 8), 10, 120))
    tl, tr = tstereo.census_transform(t(left)), tstereo.census_transform(t(right))
    out = tstereo.sgm_aggregate(tstereo.hamming_cost_volume(tl, tr, 1, 8), 10, 120)
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int32))


def test_sgm_aggregate_plain_matches_jax_volume():
    """K6's plain version (and its wrapper on CPU tensors) equals JAX's
    sgm_aggregate(hamming_cost_volume(...)) as int16, at 16x32 and D=16."""
    left, right = stereo_pair(16, 32, 5, seed=3)
    jl, jr = jstereo.census_transform(jnp.asarray(left)), jstereo.census_transform(jnp.asarray(right))
    ref = np.asarray(jstereo.sgm_aggregate(jstereo.hamming_cost_volume(jl, jr, 4, 16), 10, 120))
    cl, cr = tstereo.census_transform(t(left)), tstereo.census_transform(t(right))
    before = ksgm.AGGREGATE_COUNTER.plain_calls
    out = ksgm.sgm_aggregate(*cl, *cr, min_disparity=4, num_disparities=16, p1=10, p2=120)
    assert ksgm.AGGREGATE_COUNTER.plain_calls == before + 1
    assert out.dtype == torch.int16 and out.shape == (16, 32, 16)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="p2"):
        ksgm.sgm_aggregate(*cl, *cr, min_disparity=4, num_disparities=16, p1=10, p2=8001)


def test_sgm_param_limits_raise():
    g = torch.zeros((8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tstereo.sgm_disparity(g, g, num_disparities=8, p2=9000)
    with pytest.raises(ValueError):
        tstereo.sgm_disparity(g, g, num_disparities=8, p1=20, p2=10)


# ------------------------------------------------- disparity post-processing


@pytest.mark.parametrize("radius,iterations", [(2, 1), (3, 2)])
def test_interpolate_matches_jax(radius, iterations):
    d = sample_disparity(21, 34, seed=radius)
    kw = dict(radius=radius, iterations=iterations, min_disparity=64, max_disparity=34 * 16)
    ref = np.asarray(jdisp.interpolate(jnp.asarray(d), **kw))
    out = tdisp.interpolate(t(d), **kw).numpy()
    np.testing.assert_array_equal(out, ref)


def test_derivative_and_histogram_match_jax():
    d = sample_disparity(23, 31, seed=5)
    d[3, 4] = 32000  # int16 wrap-around of the difference
    d[3, 8] = -32000
    rd, rh = jderiv.directional_derivatives(jnp.asarray(d))
    od, oh = tderiv.directional_derivatives(t(d))
    assert od.dtype == torch.int16 and oh.dtype == torch.int32
    np.testing.assert_array_equal(od.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(oh.numpy(), np.asarray(rh))


def _ulp_distance(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_depth_matches_jax_within_2ulp():
    """Float32 within 2 ulp; inf/nan at the same positions (the JAX einsum
    may sum or fuse in another order)."""
    d = sample_disparity(17, 29, seed=6)
    d[2, 3] = 0  # W = 0 -> inf / nan
    q = np.eye(4, dtype=np.float32)
    q[0, 3], q[1, 3] = -14.5, -8.0
    q[2, 2], q[2, 3] = 0.0, 718.856
    q[3, 2], q[3, 3] = 1.0 / 0.54, 0.0
    ref = np.asarray(jdepth.reproject_to_3d(jnp.asarray(d), jnp.asarray(q)))
    out = tdepth.reproject_to_3d(t(d), q).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    assert np.isinf(ref).any()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(out[np.isinf(out)], ref[np.isinf(ref)])
    assert _ulp_distance(out[fin], ref[fin]).max() <= 2


# ----------------------------------------------------------- superpixels


def test_block_init_labels_match_jax():
    ref, rmax = jsp.block_init_labels(37, 50, 8, 8)
    out, omax = tsp.block_init_labels(37, 50, 8, 8)
    assert rmax == omax
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_init_stats_exact_sums():
    """Counts and sums equal the JAX f32 scatter (exact there); squares
    equal it where the f32 sum is exact (below 2^24) and equal the int64
    numpy sum rounded once everywhere (the port's exact-sum rule)."""
    rng = np.random.RandomState(7)
    h, w, num_labels = 24, 40, 16
    labels = rng.randint(-1, num_labels, (h, w)).astype(np.int32)
    data = rng.randint(-200, 255, (3, h, w)).astype(np.float32)
    data[0][rng.rand(h, w) < 0.1] = -32768  # invalid derivatives: 2^30 squares
    ref = np.asarray(jsp.init_stats(jnp.asarray(labels), jnp.asarray(data), num_labels,
                                    use_matmul=False))
    out = tsp.init_stats(t(labels), t(data), num_labels).numpy()

    keep = labels >= 0
    exact = np.zeros((7, num_labels), np.int64)
    di = data.astype(np.int64)
    rows = [np.ones_like(di[0]), *di, *(di * di)]
    for r, v in enumerate(rows):
        np.add.at(exact[r], labels[keep], v[keep])
    np.testing.assert_array_equal(out, exact.astype(np.float32))
    np.testing.assert_array_equal(out[:4], ref[:4])
    small = np.abs(exact[4:]) < 2**24
    np.testing.assert_array_equal(out[4:][small], ref[4:][small])
    assert not small.all()  # the case the rule is about is exercised


@pytest.mark.parametrize("channels", [9, 10])
def test_init_stats_wide_matches_jax(channels):
    """More than 8 channels route to the label tally (K7's plain version);
    the table equals JAX's f32 scatter, exact here (every entry < 2^24)."""
    rng = np.random.RandomState(channels)
    h, w, num_labels = 20, 31, 12
    labels = rng.randint(-1, num_labels, (h, w)).astype(np.int32)
    data = rng.randint(-60, 256, (channels, h, w)).astype(np.float32)
    ref = np.asarray(jsp.init_stats(jnp.asarray(labels), jnp.asarray(data), num_labels,
                                    use_matmul=False))
    before = (ktally.LABEL_COUNTER.plain_calls, ktally.MOMENT_COUNTER.plain_calls)
    out = tsp.init_stats(t(labels), t(data), num_labels)
    assert (ktally.LABEL_COUNTER.plain_calls, ktally.MOMENT_COUNTER.plain_calls) == (
        before[0] + 1, before[1])
    assert out.shape == (1 + 2 * channels, num_labels) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("c", [3, 16, 50])
def test_label_tally_matches_jax(c):
    """Per-label column sums of bf16-exact integers (the JAX function's
    contract), labels in range; equal to JAX's f32 result."""
    rng = np.random.RandomState(c)
    b, num_labels = 1500, 37
    labels = rng.randint(0, num_labels, b).astype(np.int32)
    values = rng.randint(-256, 257, (b, c)).astype(np.int32)
    ref = np.asarray(jtally.label_tally(jnp.asarray(labels), jnp.asarray(values), num_labels))
    out = ttally.label_tally(t(labels), t(values), num_labels)
    assert out.dtype == torch.float32 and out.shape == (num_labels, c)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_label_tally_drops_out_of_range_labels_and_sums_exactly():
    labels = torch.tensor([0, -1, 2, 3, 2], dtype=torch.int32)
    values = torch.tensor([[1, 2**30], [5, 1], [2, 2**30], [9, 9], [4, 1]], dtype=torch.int32)
    out = ttally.label_tally(labels, values, 3)
    # 2^30 + 1 is not a float32: the exact sum is rounded once.
    np.testing.assert_array_equal(out.numpy(), np.array(
        [[1, 2**30], [0, 0], [6, 2**30 + 1]], np.float64).astype(np.float32))


def test_moment_tally_drops_out_of_range_labels():
    labels = torch.tensor([0, -1, 2, 3, 1], dtype=torch.int32)
    data = torch.tensor([[1, 5, 2, 9, 4]], dtype=torch.int32)
    out = ktally.moment_tally(labels, data, 3)
    np.testing.assert_array_equal(out.numpy(), [[1, 1, 1], [1, 4, 2], [1, 16, 4]])


def _relax_inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    labels, _ = jsp.block_init_labels(h, w, 8, 8)
    deriv = rng.randint(-60, 60, (h, w, 2)).astype(np.float32)
    img = np.clip(rng.randn(h, w, 3) * 30 + 128 + (np.arange(w)[None, :, None] > w // 2) * 60, 0, 255)
    return np.asarray(labels), deriv, np.round(img).astype(np.float32)


@pytest.mark.parametrize("progressive", [0.0, 0.5])
def test_relax_matches_jax(progressive):
    """Labels array_equal over 5 sweeps at a geometry where every moment
    stays below 2^24 (so the f32 and exact tallies agree)."""
    h, w = 29, 43
    labels, deriv, img = _relax_inputs(h, w, seed=int(progressive * 10))
    specs = dict(disparity=1.0, image=1.5, compact=0.1)
    jspecs = [jsp.FeatureSpec("gaussian", specs["disparity"], 2),
              jsp.FeatureSpec("gaussian", specs["image"], 3, bounds=(0, 255)),
              jsp.FeatureSpec("compactness", specs["compact"], 2, progressive)]
    tspecs = [tsp.FeatureSpec("gaussian", specs["disparity"], 2),
              tsp.FeatureSpec("gaussian", specs["image"], 3),
              tsp.FeatureSpec("compactness", specs["compact"], 2, progressive)]
    num_labels = int(jsp.block_init_labels(h, w, 8, 8)[1]) + 1
    diag = 0.5 / np.sqrt(2)
    ref = np.asarray(jsp.relax(jnp.asarray(labels), [jnp.asarray(deriv), jnp.asarray(img)],
                               jspecs, num_labels, 5, 0.5, diag, stats_refresh="frame",
                               backend="xla"))
    before = krelax.COUNTER.plain_calls
    out = tsp.relax(t(labels), [t(deriv), t(img)], tspecs, num_labels, 5, 0.5, diag).numpy()
    assert krelax.COUNTER.plain_calls == before + 1  # one relax_sweeps call for all 5 sweeps
    assert (ref != labels).sum() > 0  # the sweeps moved labels
    np.testing.assert_array_equal(out, ref)


def test_relax_sweep_plain_matches_jax_phase_update():
    """One sweep from one stat image: labels equal JAX's one-sweep relax,
    and the carried stat image holds each pixel's table row exactly."""
    h, w = 21, 30
    labels, deriv, img = _relax_inputs(h, w, seed=11)
    num_labels = int(jsp.block_init_labels(h, w, 8, 8)[1]) + 1
    data = np.concatenate([np.moveaxis(deriv, -1, 0), np.moveaxis(img, -1, 0),
                           np.stack(np.meshgrid(np.arange(w), np.arange(h))).astype(np.float32)])
    feats = [krelax.RelaxFeature("gaussian", 0, 2, 1.0), krelax.RelaxFeature("gaussian", 2, 3, 1.5),
             krelax.RelaxFeature("compactness", 5, 2, 0.1)]
    stats = tsp.init_stats(t(labels), t(data), num_labels)
    stat_img = stats[:, t(labels).reshape(-1).long()].reshape(-1, h, w)
    pix = torch.cat([torch.ones(1, h, w), t(data), t(data) * t(data)])
    nl, ns = krelax.relax_sweep_plain(t(labels), stat_img, pix, feats, 7, 0.5, 0.5 / np.sqrt(2))

    # JAX's relax() returns labels only; in frame mode each pixel's carried
    # rows are the table row of its (new) label.
    ref = np.asarray(jsp.relax(jnp.asarray(labels), [jnp.asarray(deriv), jnp.asarray(img)],
                               [jsp.FeatureSpec("gaussian", 1.0, 2),
                                jsp.FeatureSpec("gaussian", 1.5, 3),
                                jsp.FeatureSpec("compactness", 0.1, 2)],
                               num_labels, 1, 0.5, 0.5 / np.sqrt(2), stats_refresh="frame",
                               backend="xla"))
    np.testing.assert_array_equal(nl.numpy(), ref)
    np.testing.assert_array_equal(ns.numpy(), stats[:, nl.reshape(-1).long()].reshape(-1, h, w).numpy())


FLAGSHIP_FEATURES = [krelax.RelaxFeature("gaussian", 0, 2, 1.0),
                     krelax.RelaxFeature("gaussian", 2, 3, 1.5),
                     krelax.RelaxFeature("compactness", 5, 2, 0.1)]


def _relax_sweeps_args(h, w, seed, progressive):
    """(labels, table, data, prog) as ops/superpixels.relax builds them for
    the flagship's layout: deriv (2) | YCrCb (3) | x, y."""
    labels, deriv, img = _relax_inputs(h, w, seed)
    num_labels = int(jsp.block_init_labels(h, w, 8, 8)[1]) + 1
    data = torch.from_numpy(np.concatenate([
        np.moveaxis(deriv, -1, 0), np.moveaxis(img, -1, 0),
        np.stack(np.meshgrid(np.arange(w), np.arange(h))).astype(np.float32)]))
    table = tsp.init_stats(t(labels), data, num_labels)
    prog = None
    if progressive:
        rows, gh = torch.arange(h, dtype=torch.float32), torch.tensor(float(h))
        prog = 1.0 + progressive * (gh - rows) / gh
    return labels, deriv, img, num_labels, table, data, prog


@pytest.mark.parametrize("iterations", [1, 5])
@pytest.mark.parametrize("progressive", [0.0, 0.5])
def test_relax_sweeps_matches_jax(iterations, progressive):
    """K3's entry on CPU tensors (its plain version) equals JAX relax in
    'frame' stats mode, labels array_equal, with and without the
    progressive compactness factor."""
    h, w = 27, 38
    labels, deriv, img, num_labels, table, data, prog = _relax_sweeps_args(
        h, w, 20 + iterations, progressive)
    ref = np.asarray(jsp.relax(jnp.asarray(labels), [jnp.asarray(deriv), jnp.asarray(img)],
                               [jsp.FeatureSpec("gaussian", 1.0, 2),
                                jsp.FeatureSpec("gaussian", 1.5, 3, bounds=(0, 255)),
                                jsp.FeatureSpec("compactness", 0.1, 2, progressive)],
                               num_labels, iterations, 0.5, 0.5 / np.sqrt(2),
                               stats_refresh="frame", backend="xla"))
    before = krelax.COUNTER.plain_calls
    out = krelax.relax_sweeps(t(labels), table, data, FLAGSHIP_FEATURES, 7, iterations, 0.5,
                              0.5 / np.sqrt(2), prog)
    assert krelax.COUNTER.plain_calls == before + 1
    assert out.dtype == torch.int32 and (ref != labels).any()
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("iterations", [0, 1, 4])
def test_relax_sweeps_stat_image_is_the_table_row(iterations):
    """With return_stats, the carried stat image (what relax_phase_pallas
    returns) equals table_gather(table, new labels) exactly, and the labels
    equal those returned without it."""
    labels, _, _, _, table, data, prog = _relax_sweeps_args(22, 35, 31, 0.5)
    args = (t(labels), table, data, FLAGSHIP_FEATURES, 7, iterations, 0.5, 0.5 / np.sqrt(2),
            prog)
    nl, ns = krelax.relax_sweeps(*args, return_stats=True)
    assert torch.equal(nl, krelax.relax_sweeps(*args))
    assert ns.shape == (15, 22, 35)
    assert torch.equal(ns, ttally.table_gather(table, nl))
    if iterations:
        assert not torch.equal(nl, t(labels))


def test_relax_launches_and_sgm_volume_padding():
    """The launch count of a K3 call, and K1's padded d stride and limits."""
    s = krelax.SWEEPS_PER_LAUNCH
    assert [krelax.launches(n) for n in (0, 1, s, s + 1, 3 * s)] == [0, 1, 1, 2, 3]
    assert [ksgm.padded_disparities(d) for d in (1, 15, 16, 48, 100, 256)] == [
        16, 16, 16, 48, 112, 256]
    with pytest.raises(ValueError, match="min_disparity"):
        ksgm._check_k1_params(120, 64, -1)
    with pytest.raises(ValueError, match="disparities"):
        ksgm._check_k1_params(120, 257, 0)


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function 'sgm_wta_kernel' for 'sm_90a'
ptxas info    : Function properties for sgm_wta_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 74 registers, used 1 barriers, 480 bytes cmem[0]
ptxas info    : Compiling entry function 'relax_sweeps_kernel' for 'sm_90a'
ptxas info    : Function properties for relax_sweeps_kernel
    8 bytes stack frame, 12 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 64 registers, 16 bytes smem, 480 bytes cmem[0]
"""


def test_ptxas_report_is_parsed_per_kernel():
    """build.kernel_resources reads each kernel's registers, static shared
    memory, stack and spill bytes from an nvcc -Xptxas -v report, and
    _short_name strips a demangled name to the kernel and its template."""
    got = build.kernel_resources(PTXAS_REPORT)
    assert got == [
        dict(name="sgm_wta_kernel", registers=74, smem=0, stack=0, spill_stores=0,
             spill_loads=0),
        dict(name="relax_sweeps_kernel", registers=64, smem=16, stack=8, spill_stores=12,
             spill_loads=24)]
    for demangled in ("void (anonymous namespace)::relax_sweeps_kernel<true>(int const*, int)",
                      "void <unnamed>::relax_sweeps_kernel<true>(int*)"):
        assert build._short_name(demangled) == "relax_sweeps_kernel<true>"
    assert build._short_name("void sgm_hpaths_kernel<short, (int)8>(int const*, short*)") == \
        "sgm_hpaths_kernel<short, (int)8>"


# ---------------------------------------------------------------- planes


def test_classify_matches_jax():
    rng = np.random.RandomState(8)
    d = rng.randint(-60, 60, (19, 27)).astype(np.int16)
    d[rng.rand(19, 27) < 0.1] = -32768
    ranges = np.array([[3, 40], [-6, 3]], np.int32)
    ref = np.asarray(jplane.classify(jnp.asarray(d), jnp.asarray(ranges)))
    out = tplane.classify(t(d), t(ranges)).numpy()
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


def test_superpixel_vote_matches_jax():
    rng = np.random.RandomState(9)
    h, w, num_labels = 26, 35, 21
    labels = rng.randint(0, num_labels, (h, w)).astype(np.int32)
    planes = rng.randint(0, 3, (h, w)).astype(np.uint8)
    planes[labels % 4 == 0] = 1  # clear winners beside near ties
    ref = np.asarray(jplane.superpixel_vote(jnp.asarray(planes), jnp.asarray(labels), num_labels))
    before = ktally.VOTE_COUNTER.plain_calls
    out = tplane.superpixel_vote(t(planes), t(labels), num_labels).numpy()
    assert ktally.VOTE_COUNTER.plain_calls == before + 1
    np.testing.assert_array_equal(out, ref)


def _vote_inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    current = rng.randint(0, 3, (h, w)).astype(np.uint8)
    prev = rng.randint(0, 3, (h, w)).astype(np.uint8)
    state = rng.randint(0, 4, (3, h, w)).astype(np.uint8)
    # S10.5 flow with integer parts up to +-50 px: beyond max_warp (6, 9)
    # below, and sources outside the frame.
    flow = rng.randint(-50 * 32, 50 * 32, (h, w, 2)).astype(np.int16)
    flow[: h // 2] //= 8  # half the frame moves within the bound
    return current, prev, state, flow


@pytest.mark.parametrize("mode", ["gather", "select"])
def test_temporal_vote_warped_matches_jax(mode):
    """Both warp modes against JAX called with the same explicit mode; the
    votes and the carried stack equal."""
    h, w = 23, 37
    current, prev, state, flow = _vote_inputs(h, w, seed=len(mode))
    kw = dict(current_weight=2, compare_unknown=True, warp_mode=mode, max_warp_y=6,
              max_warp_x=9)
    rv, rs = jplane.temporal_vote_warped(jnp.asarray(current), jnp.asarray(prev),
                                         jnp.asarray(state), jnp.asarray(flow), **kw)
    ov, os_ = tplane.temporal_vote_warped(t(current), t(prev), t(state), t(flow), **kw)
    assert ov.dtype == torch.uint8 and os_.dtype == torch.uint8
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(os_.numpy(), np.asarray(rs))
    # Some votes were dropped (out of the frame, or beyond the bound).
    assert (np.asarray(rs)[0] == tplane.WARP_INVALID).any()


def test_temporal_vote_auto_is_gather_and_pixel_rule_matches_jax():
    h, w = 17, 29
    current, prev, state, flow = _vote_inputs(h, w, seed=11)
    args = (t(current), t(prev), t(state), t(flow))
    auto = tplane.temporal_vote_warped(*args, 1, False)
    gather = tplane.temporal_vote_warped(*args, 1, False, warp_mode="gather")
    ref = jplane.temporal_vote_warped(jnp.asarray(current), jnp.asarray(prev),
                                      jnp.asarray(state), jnp.asarray(flow), 1, False,
                                      warp_mode="gather")
    for a, g, r in zip(auto, gather, ref):
        np.testing.assert_array_equal(a.numpy(), g.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="warp_mode"):
        tplane.temporal_vote_warped(*args, 1, False, warp_mode="nearest")


def test_separable_warp_matches_jax():
    rng = np.random.RandomState(12)
    img = rng.randint(0, 1 << 20, (19, 26)).astype(np.int32)
    fy = rng.randint(-8, 9, (19, 26)).astype(np.int32)
    fx = rng.randint(-12, 13, (19, 26)).astype(np.int32)
    rw, rv = jwarp.separable_warp(jnp.asarray(img), jnp.asarray(fy), jnp.asarray(fx), 5, 10,
                                  fill=-1)
    ow, ov = twarp.separable_warp(t(img), t(fy), t(fx), 5, 10, fill=-1)
    np.testing.assert_array_equal(ow.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))


def test_vote_tally_plain_counts():
    labels = torch.tensor([0, 0, 1, 2, -1, 2], dtype=torch.int32)
    votes = torch.tensor([1, 1, 2, 0, 1, 0], dtype=torch.uint8)
    out = ktally.vote_tally(labels, votes, 3, 3)
    np.testing.assert_array_equal(out.numpy(), [[0, 2, 0], [0, 0, 1], [2, 0, 0]])


# ------------------------------------------------------- kernel wrappers


def test_expect_rejects_cpu_tensors():
    """The CUDA path of every wrapper checks its tensors: a CPU tensor is
    never handed to a kernel."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        build.expect(torch.zeros(4, dtype=torch.int32), "x", torch.int32)


def test_counters_reset():
    ksgm.COUNTER.launches, ksgm.COUNTER.plain_calls = 3, 2
    build.reset_counts()
    assert all(c.launches == 0 and c.plain_calls == 0 for c in build.COUNTERS.values())
    assert {"sgm", "sgm_aggregate", "moment_tally", "relax", "vote_tally",
            "label_tally"} <= set(build.COUNTERS)
