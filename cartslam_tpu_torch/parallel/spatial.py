"""Width-sharded stencils over a shard group (counterpart of
cartslam_tpu/parallel/spatial.py).

The image width is split over the group's n shards; each shard extends its
columns with its neighbours' (``exchange_width_halo``), applies the dense
op, and crops; a histogram finishes with a ``psum``.  Each function takes a
ShardGroup and returns a function of the whole image (its width a multiple
of n), which places shard i's columns on the group's device i and returns
the merged result on the input's device, as the JAX functions take and give
arrays sharded over the mesh's width axis.  The JAX versions are jnp (no
Pallas kernel); these are torch ops.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import derivative as dops
from ..ops import disparity as dsp
from ..ops import planeseg as pops
from .halo import exchange_width_halo


def _columns(x: torch.Tensor, group, i: int) -> torch.Tensor:
    w = x.shape[1]
    if w % group.n:
        raise ValueError(f"width {w} does not split over {group.n} shards")
    w_local = w // group.n
    return x[:, i * w_local:(i + 1) * w_local].contiguous().to(group.devices[i],
                                                                 non_blocking=True)


def _merge(parts: list, device) -> torch.Tensor:
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=1)


def sharded_derivative(group) -> Callable:
    """Width-sharded ``directional_derivatives``: int16 [H, W] ->
    (derivatives int16 [H, W, 2], histogram int32 [256, 2], psum'd)."""

    def local(d: torch.Tensor):
        deriv = dops.directional_derivatives(exchange_width_halo(d, 2, group))[0][:, 2:-2]
        hist = torch.stack([dops.hist256(deriv[..., c].to(torch.int32),
                                         deriv[..., c] != dops.DERIVATIVE_INVALID)
                            for c in range(2)], dim=-1)
        return deriv, group.psum(hist)

    def f(disparity: torch.Tensor):
        out = group.run(lambda i: local(_columns(disparity, group, i)))
        return (_merge([o[0] for o in out], disparity.device),
                out[0][1].to(disparity.device))

    return f


def sharded_interpolate(group, *, radius: int, iterations: int, min_disparity: int,
                        max_disparity: int) -> Callable:
    """Width-sharded ``interpolate``, one halo exchange per iteration (the
    stencil's reach, radius - 1 columns each side)."""
    halo = radius - 1

    def local(d: torch.Tensor) -> torch.Tensor:
        for _ in range(iterations):
            ext = exchange_width_halo(d, halo, group) if halo else d
            out = dsp.interpolate(ext, radius=radius, iterations=1,
                                  min_disparity=min_disparity, max_disparity=max_disparity)
            d = out[:, halo:out.shape[1] - halo]
        return d

    def f(disparity: torch.Tensor) -> torch.Tensor:
        return _merge(group.run(lambda i: local(_columns(disparity, group, i))),
                      disparity.device)

    return f


def sharded_classify(group) -> Callable:
    """Width-sharded plane classification (pointwise: no halo)."""

    def f(derivative: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
        return _merge(group.run(lambda i: pops.classify(
            _columns(derivative, group, i), ranges.to(group.devices[i]))), derivative.device)

    return f
