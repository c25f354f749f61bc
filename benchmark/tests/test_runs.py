"""Whole runs of the harness on the CPU at the tiny geometry: the program
held against the reference in both drain orders and in the multi-sequence
mode (three streams in lock-step), and runs with the timed path broken
underneath, which have to come out not correct.

The harness's look for a card is the command's (benchmark/run.py); here
``run_cell`` is called with the CPU, where the System runs its eager step
(the same modules and kernels' plain versions), with the same drain order,
snapshots and host step as on the card."""

import time

import pytest
import torch

from benchmark import compare, harness
from benchmark.reference import chain as reference
from benchmark.reference import ops
from benchmark.reference.provider import HostStep
from benchmark.tests.tiny import FLEET

# The window of a run: a round of the three tiny streams takes the eager
# multi-sequence System about half a second on the CPU.
SECONDS = {"tiny.stream": 2.0, "tiny.cam": 2.0, "tiny.fleet": 4.0}


def run(root, workload, seed=20260418, trace=False, patch=None):
    return harness.run_cell(root, workload, seed, SECONDS[workload], trace, "cpu",
                            time.perf_counter(), patch=patch)


@pytest.mark.parametrize("workload,trace,names", [
    ("tiny.stream", False, {"fps", "setup_s"}),
    # The CPU has no device trace: only the span readers find something.
    ("tiny.cam", True, {"frame_span_ms.cam", "queue_wait_ms.cam"}),
    ("tiny.fleet", False, {"fps", "setup_s"}),
    ("tiny.fleet", True, {"read_ms.fleet"}),
])
def test_program_equals_reference(tiny_root, workload, trace, names):
    """4 frames in flight (closed loop), 1 (open loop, traced) and 4 rounds
    of three streams (the multi-sequence mode): every delivered frame's
    planes and histogram, every stream's final state and the plane
    parameters equal the reference's."""
    result = run(tiny_root, workload, trace=trace)
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"
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


@pytest.mark.parametrize("workload,rounds", [("tiny.stream", 40), ("tiny.fleet", 16)])
def test_control_in_the_programs_place_is_not_correct(tiny_root, workload, rounds):
    """The reference computed in bfloat16 where the configuration states
    float32, handed over as the program's run, fails the comparison."""
    from benchmark.control import control_readings

    readings = control_readings(tiny_root, workload, seed=7, frames=rounds, device="cpu")
    assert not compare.correct(readings), readings


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
    streams, _ = harness.render_streams(config, traffic, 11, "cpu")
    m, snap, n = traffic["max_in_flight"], config["system"]["snapshot_interval"], 36
    modules = config["modules"]
    want = _single_stream_replay(reference.Chain(modules, streams[0], "cpu"), n, m, snap)
    got = []
    out = reference.replay(reference.chains(modules, streams, "cpu"), n, m, snap,
                           lambda t, planes, hist: got.append((t, planes, hist)))
    assert [t for t, _, _ in got] == list(range(1, n + 1))
    for (_, planes, hist), (p1, h1) in zip(got, want["frames"]):
        assert planes.shape[0] == hist.shape[0] == 1
        assert torch.equal(planes[0], p1) and torch.equal(hist[0], h1)
    assert out["state"].keys() == want["state"].keys()
    for path, value in want["state"].items():
        assert torch.equal(out["state"][path][0], value), path
    assert out["params"] == want["params"]
    # The planes change from frame to frame: the comparison is not of constants.
    assert len({planes.numpy().tobytes() for _, planes, _ in got}) > 1
