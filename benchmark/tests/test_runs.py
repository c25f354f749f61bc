"""Whole runs of the harness on the CPU at the tiny geometry: the program
held against the reference in both drain orders, and runs with the timed
path broken underneath, which have to come out not correct.

The harness's look for a card is the command's (benchmark/run.py); here
``run_cell`` is called with the CPU, where the System runs its eager step
(the same modules and kernels' plain versions), with the same drain order,
snapshots and host step as on the card."""

import time

import pytest
import torch

from benchmark import compare, harness

SECONDS = 2.0


def run(root, workload, seed=20260418, trace=False, patch=None):
    return harness.run_cell(root, workload, seed, SECONDS, trace, "cpu", time.perf_counter(),
                            patch=patch)


@pytest.mark.parametrize("workload,trace", [("tiny.stream", False), ("tiny.cam", True)])
def test_program_equals_reference(tiny_root, workload, trace):
    """4 frames in flight (closed loop) and 1 (open loop, traced): every
    delivered frame's planes and histogram, the final state and the plane
    parameters equal the reference's."""
    result = run(tiny_root, workload, trace=trace)
    assert result["correct"], result["checks"]
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result)[-1] == "checks"
    names = set(result["metrics"])
    if trace:
        # The CPU has no device trace: only the span readers find something.
        assert names == {"frame_span_ms.cam", "queue_wait_ms.cam"}
    else:
        assert names == {"fps", "setup_s"}
        assert result["attempted"] > 0 and result["failed"] == 0


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


@pytest.mark.parametrize("fault", [_state_unchanged, _planes_altered, _half_frame_skipped])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    result = run(tiny_root, "tiny.stream",
                 patch=lambda: monkeypatch.setattr(*fault()))
    assert not result["correct"], result["checks"]


def test_control_in_the_programs_place_is_not_correct(tiny_root):
    """The reference computed in bfloat16 where the configuration states
    float32, handed over as the program's run, fails the comparison."""
    from benchmark.control import control_readings

    readings = control_readings(tiny_root, "tiny.stream", seed=7, frames=40, device="cpu")
    assert not compare.correct(readings), readings
