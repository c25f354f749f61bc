"""Whole runs of the harness on the CPU at the tiny geometry: the program
held against the reference in both drain orders, in the multi-sequence
mode (three streams in lock-step) and with depth fetched, a chain judged by
a reference module of its own, and runs with the timed path broken
underneath, which have to come out not correct.

The harness's look for a card is the command's (benchmark/run.py); here
``run_cell`` is called with the CPU, where the System runs its eager step
(the same modules and kernels' plain versions), with the same drain order,
snapshots and host step as on the card."""

import time

import numpy as np
import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import chain as reference
from benchmark.reference import ops
from benchmark.reference.checks import Check
from benchmark.reference.provider import HostStep
from benchmark.tests.tiny import FLEET, MODULES

# The window of a run: a round of the three tiny streams takes the eager
# multi-sequence System about half a second on the CPU.
SECONDS = {"tiny.stream": 2.0, "tiny.cam": 2.0, "tiny.fleet": 4.0, "tiny.bev": 2.0,
           "tiny.unchecked": 2.0, "tiny-disp.stream": 2.0}
PLANESEG_CHECKS = ["frames_missing", "planes_px_diff", "hist_bins_diff", "state_diff",
                   "params_diff"]


def run(root, workload, seed=20260418, trace=False, patch=None):
    return harness.run_cell(root, workload, seed, SECONDS[workload], trace, "cpu",
                            time.perf_counter(), patch=patch)


@pytest.mark.parametrize("workload,trace,names", [
    ("tiny.stream", False, {"fps", "setup_s"}),
    # The CPU has no device trace: only the span readers find something.
    ("tiny.cam", True, {"frame_span_ms.cam", "queue_wait_ms.cam"}),
    ("tiny.fleet", False, {"fps", "setup_s"}),
    ("tiny.fleet", True, {"read_ms.fleet"}),
    ("tiny.bev", False, {"fps", "setup_s"}),
    ("tiny.bev", True, {"fetch_copy_ms.bev", "host_step_ms"}),
])
def test_program_equals_reference(tiny_root, workload, trace, names):
    """4 frames in flight (closed loop), 1 (open loop, traced), 4 rounds of
    three streams (the multi-sequence mode) and 4 frames in flight with
    depth fetched: every delivered frame's planes, histogram and (tiny.bev)
    depth, every stream's final state and the plane parameters equal the
    reference's."""
    result = run(tiny_root, workload, trace=trace)
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"
    # The cells that fetch the planes alone print the plane segmentation's
    # check lines of before depth was compared; a fetch of depth adds its own.
    want = list(PLANESEG_CHECKS)
    if workload == "tiny.bev":
        want.insert(3, "depth_diff")
    assert list(result["checks"]) == want
    assert set(result["metrics"]) == names
    if not trace:
        assert result["attempted"] > 0 and result["failed"] == 0
    if workload == "tiny.fleet":
        # Counted in stereo frames: whole rounds of the three streams.
        assert result["attempted"] % FLEET == 0


def _state_unchanged():
    """The step returns the state it was given."""
    from cartslam_tpu_torch.runtime.pipeline import Pipeline

    step = Pipeline.compute_step

    def frozen(self, state, *args, **kw):
        _, outputs = step(self, state, *args, **kw)
        return state, outputs

    return Pipeline, "compute_step", frozen


def _planes_altered():
    """One pixel of every tenth frame's planes is altered where the module
    produces it."""
    from cartslam_tpu_torch.models.sp_planeseg import SuperPixelDisparityPlaneSegmentationModule

    compute = SuperPixelDisparityPlaneSegmentationModule.compute

    def altered(self, ctx, step, deps, state, params, variant):
        out, new_state = compute(self, ctx, step, deps, state, params, variant)
        planes = out["planes"].clone()
        flip = (step.frame_id % 10 == 0).to(torch.uint8)
        planes[0, 0] = (planes[0, 0] + flip) % 3
        return {**out, "planes": planes}, new_state

    return SuperPixelDisparityPlaneSegmentationModule, "compute", altered


def _half_frame_skipped():
    """The disparity of the bottom half of the frame is left out (invalid)."""
    from cartslam_tpu_torch.models.disparity import ImageDisparityModule

    compute = ImageDisparityModule.compute

    def halved(self, ctx, step, deps, state, params, variant):
        out, new_state = compute(self, ctx, step, deps, state, params, variant)
        disp = out["disparity"].clone()
        disp[disp.shape[0] // 2:] = -32768
        return {"disparity": disp}, new_state

    return ImageDisparityModule, "compute", halved


def _one_stream_altered():
    """One pixel of stream 1's planes is altered in round 3, where the
    batched step produces the round's planes."""
    from cartslam_tpu_torch.parallel import system

    step = system.batched_step

    def altered(pipeline, state, frame, *args, **kw):
        new_state, outputs = step(pipeline, state, frame, *args, **kw)
        planes = outputs["planes"].clone()
        flip = (frame["frame_id"] == 3).to(torch.uint8)
        planes[1, 0, 0] = (planes[1, 0, 0] + flip) % 3
        return new_state, {**outputs, "planes": planes}

    return system, "batched_step", altered


def _provider_sees_sequence_zero():
    """The provider is fed sequence 0's derivative histogram in place of the
    batch's sum: the plane segmentation declares no batch reduction, so the
    multi-sequence System falls back to sequence 0."""
    from cartslam_tpu_torch.models.sp_planeseg import SuperPixelDisparityPlaneSegmentationModule

    return SuperPixelDisparityPlaneSegmentationModule, "host_fetch_reduce", lambda self: {}


@pytest.mark.parametrize("workload,fault", [
    ("tiny.stream", _state_unchanged), ("tiny.stream", _planes_altered),
    ("tiny.stream", _half_frame_skipped), ("tiny.fleet", _state_unchanged),
    ("tiny.fleet", _one_stream_altered), ("tiny.fleet", _provider_sees_sequence_zero),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, workload, fault):
    result = run(tiny_root, workload, patch=lambda: monkeypatch.setattr(*fault()))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload,rounds", [("tiny.stream", 40), ("tiny.fleet", 16),
                                             ("tiny.bev", 40)])
def test_control_in_the_programs_place_is_not_correct(tiny_root, workload, rounds):
    """The reference computed in bfloat16 where the configuration states
    float32, handed over as the program's run, fails the comparison; with
    depth fetched, the depth's own check fails too."""
    from benchmark.control import control_readings

    readings = control_readings(tiny_root, workload, seed=7, frames=rounds, device="cpu")
    assert not compare.correct(readings), readings
    if workload == "tiny.bev":
        assert readings["depth_diff"]["value"] > 0, readings


def _depth_altered(frame_id):
    """One element of frame `frame_id`'s depth is altered (one bit of its
    float32 pattern) where the module produces it."""

    def fault():
        from cartslam_tpu_torch.models.depth import DepthModule

        compute = DepthModule.compute

        def altered(self, ctx, step, deps, state, params, variant):
            out, new_state = compute(self, ctx, step, deps, state, params, variant)
            depth = out["depth"].clone()
            depth.view(torch.int32)[1, 2, 0] ^= (step.frame_id == frame_id).to(torch.int32)
            return {**out, "depth": depth}, new_state

        return DepthModule, "compute", altered

    return fault


@pytest.mark.parametrize("frame_id", [3, 19], ids=["first_copy", "later_delivery"])
def test_one_altered_depth_element_is_counted(tiny_root, monkeypatch, frame_id):
    """Frame 3 is the first delivery of its cycle position, held for the
    reference; frame 19 a later one, compared with frame 3's copy as it
    comes (the cycle is 8 frames).  Frame 19 altered counts its one element
    once.  Frame 3 altered counts it against the reference, and once more
    for each later delivery of the position, each of which differs from
    the held copy in that element.  Either way the run is not correct."""
    delivered = []
    put = compare.Deliveries.put

    def counted_put(self, t, outputs):
        delivered.append(t)
        put(self, t, outputs)

    def patch():
        monkeypatch.setattr(*_depth_altered(frame_id)())
        monkeypatch.setattr(compare.Deliveries, "put", counted_put)

    result = run(tiny_root, "tiny.bev", patch=patch)
    assert not result["correct"]
    checks = {k: c["value"] for k, c in result["checks"].items()}
    of_position = sum(1 for t in delivered if (t - 1) % 8 == 2)
    assert of_position >= 3 and 19 in delivered
    want = of_position if frame_id == 3 else 1
    assert checks == {**dict.fromkeys(checks, 0), "depth_diff": want}, checks


def test_a_fetched_key_the_reference_does_not_produce_raises(tiny_root):
    """tiny.unchecked fetches the disparity, which the plane segmentation's
    reference does not compare: the run stops before its System is built.
    So does a fetch of depth from a chain without the depth module."""
    with pytest.raises(compare.Unchecked, match="disparity"):
        run(tiny_root, "tiny.unchecked")
    no_depth = [m for m in MODULES if m["type"] != "depth"]
    with pytest.raises(compare.Unchecked, match="depth"):
        compare.checks_of(reference, no_depth, ["planes", "depth"])


def _disparity_altered():
    """One pixel of every frame's disparity is altered where the module
    produces it."""
    from cartslam_tpu_torch.models.disparity import ImageDisparityModule

    compute = ImageDisparityModule.compute

    def altered(self, ctx, step, deps, state, params, variant):
        out, new_state = compute(self, ctx, step, deps, state, params, variant)
        disp = out["disparity"].clone()
        disp[40, 80] ^= 1
        return {**out, "disparity": disp}, new_state

    return ImageDisparityModule, "compute", altered


@pytest.mark.parametrize("fault", [None, _disparity_altered], ids=["sound", "disparity_altered"])
def test_a_second_reference_judges_its_own_chain(tiny_root, monkeypatch, fault):
    """tiny-disp's configuration names benchmark/tests/disparity_reference.py:
    the run of its chain (disparity, derivatives, depth) is judged by that
    module's checks, and one pixel of the disparity altered in every frame
    counts once a delivered frame in them."""
    patch = None if fault is None else (lambda: monkeypatch.setattr(*fault()))
    result = run(tiny_root, "tiny-disp.stream", patch=patch)
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert list(checks) == ["frames_missing", "disparity_px_diff", "derivative_px_diff",
                            "depth_diff", "state_diff", "params_diff"]
    if fault is None:
        assert result["correct"] and not any(checks.values()), checks
    else:
        assert not result["correct"]
        delivered = result["attempted"] - result["failed"]
        assert checks["disparity_px_diff"] >= delivered > 0, checks
        assert checks["derivative_px_diff"] >= delivered, checks
        assert checks["depth_diff"] >= 3 * delivered, checks


def test_deliveries_hold_one_copy_a_position():
    """Outputs kept "first": the first delivery of a position is held, with
    the number of deliveries equal to it byte for byte; a later one that
    differs is dropped and adds its count of differing elements, -0.0
    against 0.0 included."""
    checks = [Check("a", "a_diff", "tests"), Check("d", "d_diff", "tests", kept="first")]
    d = np.zeros((1, 3), np.float32)
    sequence = [d, d, d, -d, d + 1, d, d + 2, d + 3, d + 4]  # -d: -0.0, its own bytes
    held = compare.Deliveries(checks, cycle=2)
    for t, depth in enumerate(sequence, start=1):
        held.put(t, {"a": np.full((1, 2), t), "d": depth.copy()})
    held.close()
    assert sorted(held.rounds) == list(range(1, 10))
    assert all(set(r) == {"a"} for r in held.rounds.values())
    assert sorted(held.waited) == list(range(1, 10))
    # Position 0 (rounds 1, 3, 5, 7, 9): d, d, d + 1, d + 2, d + 4: two equal,
    # three differing in 3 elements each; position 1 (rounds 2, 4, 6, 8):
    # d, -0.0, d, d + 3: two equal, two differing in 3 elements each.
    assert {p: c for p, (_, c) in held.copies.items()} == {0: 2, 1: 2}
    assert all(np.array_equal(copy["d"], d) for copy, _ in held.copies.values())
    assert held.differing == {"d": 15}
    assert held.held_bytes() == 2 * d.nbytes


def test_the_reference_is_loaded_from_the_checked_file(tiny_root):
    """The configuration's reference is the file under the checkout's root
    that spec.validate checked, not a module of that name found elsewhere
    on the path."""
    from pathlib import Path

    from benchmark.tests.tiny import REPO

    config = {"reference": "benchmark/reference/chain.py"}
    copy = tiny_root / "benchmark" / "reference" / "chain.py"
    copy.write_text(copy.read_text() + "\nLOADED_FROM = 'the checkout'\n")
    module = compare.reference_of(tiny_root, config)
    assert Path(module.__file__).resolve() == copy.resolve()
    assert module.LOADED_FROM == "the checkout"
    assert compare.reference_of(tiny_root, config) is module
    module = compare.reference_of(REPO, config)
    assert Path(module.__file__).resolve() == (REPO / config["reference"]).resolve()
    assert not hasattr(module, "LOADED_FROM")


def _single_stream_replay(chain: reference.Chain, n: int, max_in_flight: int,
                          snapshot_interval: int) -> dict:
    """The reference's replay of one stream as it was written before the
    lock-step replay: frame by frame, the host step fed the stream's own
    histogram, no batch axis anywhere."""
    s = chain.s
    host = HostStep(s["update_interval"], s["reset_interval"])
    ranges_np = host.params.ranges()
    ranges = torch.from_numpy(ranges_np)
    drained, cycle = 0, len(chain.frames)
    warp = torch.full((s["distance"], chain.h, chain.w), ops.WARP_INVALID, dtype=torch.uint8)
    pixel_prev, labels, segment, frames = None, chain.grid, (), []
    for t in range(1, n + 1):
        last_snapshot = (t - 1) // snapshot_interval * snapshot_interval
        while drained < max(t - max_in_flight, last_snapshot):
            drained += 1
            got = host.update(drained, chain.products((drained - 1) % cycle)["hist_np"])
            if got is not None:
                ranges_np = got
                ranges = torch.from_numpy(ranges_np)
        i = (t - 1) % cycle
        p = chain.products(i)
        reset = t == 1 or t % s["reset_iterations"] == 0
        segment = (i,) if reset else segment + (i,)
        labels = chain.labels(segment, chain.grid if reset else labels,
                              s["initial_iterations"] if reset else s["iterations"])
        pixel = ops.classify(p["deriv"][..., 0], ranges)
        flow = (torch.zeros((chain.h, chain.w, 2), dtype=torch.int16) if t == 1
                else chain.flow((t - 2) % cycle, i))
        prev = torch.full_like(pixel, ops.WARP_INVALID) if pixel_prev is None else pixel_prev
        voted, warp = ops.temporal_vote_warped(pixel, prev, warp, flow, 2, True)
        frames.append((ops.superpixel_vote(voted, labels, chain.num_labels), p["hist"]))
        pixel_prev = pixel
    while drained < n:
        drained += 1
        host.update(drained, chain.products((drained - 1) % cycle)["hist_np"])
    state = {"modules/SuperPixelDetect/labels": labels,
             "modules/ImageOpticalFlow/prev_gray": chain.products((n - 1) % cycle)["gray"],
             "modules/SPPlaneSegmentation/warp_votes": warp,
             "history/planes_unsmoothed": pixel_prev[None]}
    return {"frames": frames, "state": state, "params": host.params}


def test_the_lock_step_of_one_stream_is_the_single_stream_replay(tiny_root):
    """The lock-step reference at B = 1 on tiny.stream's frames gives the
    planes, histograms, state and parameters of the single-stream replay,
    over frames that cross grid resets, provider updates and snapshots."""
    from benchmark import spec

    bench = spec.load(tiny_root)
    config = spec.load_config(tiny_root, bench, "tiny")
    traffic = spec.load_traffic(tiny_root, "tiny_stream")
    streams, q = harness.render_streams(config, traffic, 11, "cpu")
    m, snap, n = traffic["max_in_flight"], config["system"]["snapshot_interval"], 36
    modules = config["modules"]
    want = _single_stream_replay(reference.Chain(modules, streams[0], q, "cpu"), n, m, snap)
    got = []
    out = reference.replay(reference.chains(modules, streams, q, "cpu"), n, m, snap,
                           lambda t, o: got.append((t, o[reference.PLANES], o[reference.HIST])),
                           [reference.PLANES, reference.HIST])
    assert [t for t, _, _ in got] == list(range(1, n + 1))
    for (_, planes, hist), (p1, h1) in zip(got, want["frames"]):
        assert planes.shape[0] == hist.shape[0] == 1
        assert torch.equal(planes[0], p1) and torch.equal(hist[0], h1)
    assert out["state"].keys() == want["state"].keys()
    for path, value in want["state"].items():
        assert torch.equal(out["state"][path][0], value), path
    assert out["global"] == want["params"]
    # The planes change from frame to frame: the comparison is not of constants.
    assert len({planes.numpy().tobytes() for _, planes, _ in got}) > 1
