"""A second reference module, for the tests: the chain of disparity, its
directional derivatives and depth, with checks of its own, one of which
counts in a way of its own (pixels, not elements).  A tiny configuration
names it in its ``reference`` key, and its runs are judged by these checks,
not by the plane segmentation's: a chain comes into the benchmark by files
alone.

Every output depends on the frame alone, so each is worked out once per
distinct frame of a stream; the chain keeps no state and compares no host
global.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference.checks import Check

DISPARITY, DERIVATIVE, DEPTH = "disparity", "disparity_derivative", "depth"


def _pixels_differ(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Pixels [..., H, W] whose two derivative channels differ in either."""
    if got.shape != want.shape:
        return torch.tensor(want[..., 0].numel())
    return (got != want).any(dim=-1).sum()


CHECKS = (
    Check(DISPARITY, "disparity_px_diff", "pixels of the delivered frames' disparity that "
          "differ"),
    Check(DERIVATIVE, "derivative_px_diff", "pixels of the delivered frames' derivatives that "
          "differ in either direction", diff=_pixels_differ),
    Check(DEPTH, "depth_diff", "elements of the delivered frames' depth whose bit patterns "
          "differ", kept="first"),
)
GLOBAL = None
TYPES = ["disparity", "disparity_derivative", "depth"]


def _disparity_settings(modules: list[dict]) -> dict:
    if [m["type"] for m in modules] != TYPES:
        raise NotImplementedError(f"this reference follows {TYPES}, not {modules}")
    return modules[0]


def outputs(modules: list[dict]) -> set[str]:
    _disparity_settings(modules)
    return {DISPARITY, DERIVATIVE, DEPTH}


def global_diff(got, want) -> int:
    return 0


class Chain:
    def __init__(self, modules, frames, q, device, fdt=torch.float32):
        self.dp = _disparity_settings(modules)
        self.frames, self.q, self.fdt = frames, torch.as_tensor(q), fdt
        self.device = torch.device(device)
        self._outputs: dict[int, dict] = {}

    def outputs(self, t: int) -> dict:
        i = (t - 1) % len(self.frames)
        if i not in self._outputs:
            left, right = (torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                           for x in self.frames[i])
            dp = self.dp
            disp = ops.sgm_disparity(ops.bgr_to_gray(left, self.fdt),
                                     ops.bgr_to_gray(right, self.fdt),
                                     min_disparity=dp.get("min_disparity", 4),
                                     num_disparities=dp.get("num_disparities", 256), p1=10,
                                     p2=120, uniqueness=12)
            if dp.get("smoothing_radius", -1) > 0:
                disp = ops.interpolate(disp, radius=dp["smoothing_radius"],
                                       iterations=dp.get("smoothing_iterations", 5),
                                       min_disparity=dp.get("min_disparity", 4) * 16,
                                       max_disparity=disp.shape[1])
            self._outputs[i] = {DISPARITY: disp, DERIVATIVE: ops.directional_derivatives(disp)[0],
                                DEPTH: ops.reproject_to_3d(disp, self.q, self.fdt)}
        return self._outputs[i]


def chains(modules, streams, q, device, fdt=torch.float32) -> list[Chain]:
    return [Chain(modules, frames, q, device, fdt) for frames in streams]


def replay(chains, n, max_in_flight, snapshot_interval, visit, keys) -> dict:
    for t in range(1, n + 1):
        outs = [c.outputs(t) for c in chains]
        visit(t, {k: torch.stack([o[k] for o in outs]) for k in keys})
    return {"state": {}, "global": None}
