"""The optical flow's 3x3 medians, csrc/median.cu, with their plain version.

Replaces no TPU kernel: the JAX package's ``_median3x3``
(cartslam_tpu/ops/optflow.py:104) is a min/max network of jnp ops.  Here
``median3x3(x, passes)`` runs `passes` consecutive edge-clamped 3x3 medians
of every [h, w] plane of a float32 [..., h, w] tensor: on a CUDA tensor in
ceil(passes / 2) launches (two passes fused a launch, one for an odd
remainder), on a CPU tensor as the plain version, ops/optflow's gather and
``median``, `passes` times.  Both select one of nine exact values, so they
are equal bit for bit.
"""

from __future__ import annotations

import math

import torch

from ..ops.optflow import _median3x3
from . import build

MEDIAN_COUNTER = build.counter("median3x3")
MAX_PLANES = 65535  # the grid's z axis


def median3x3_plain(x: torch.Tensor, passes: int) -> torch.Tensor:
    for _ in range(passes):
        x = _median3x3(x)
    return x


@build.on_its_card
def median3x3(x: torch.Tensor, passes: int) -> torch.Tensor:
    """`passes` 3x3 medians (edge-clamped) of each [h, w] plane of x
    (float32 [..., h, w]); 0 passes return x."""
    if x.dtype != torch.float32:
        raise ValueError(f"median3x3: dtype {x.dtype}, expected torch.float32")
    if x.dim() < 2:
        raise ValueError(f"median3x3: shape {tuple(x.shape)}, expected [..., h, w]")
    if passes < 0:
        raise ValueError(f"median3x3: {passes} passes")
    if passes == 0:
        return x
    if x.device.type == "cpu":
        MEDIAN_COUNTER.plain_calls += 1
        return median3x3_plain(x, passes)
    build.expect(x, "x", torch.float32)
    h, w = x.shape[-2:]
    planes = math.prod(x.shape[:-2])
    if planes > MAX_PLANES:
        raise ValueError(f"median3x3: {planes} planes, at most {MAX_PLANES}")
    lib = build.library()
    while passes:
        step = min(passes, 2)
        out = torch.empty_like(x)
        build.check(lib.median3x3(x.data_ptr(), out.data_ptr(), planes, h, w, step,
                                  build.stream()), "median3x3")
        MEDIAN_COUNTER.launches += 1
        x, passes = out, passes - step
    return x
