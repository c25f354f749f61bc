"""Row- and width-halo exchange over a shard group (counterpart of
cartslam_tpu/parallel/halo.py and of ``exchange_width_halo`` in
cartslam_tpu/parallel/spatial.py).

Neighbour rows come from the adjacent shards with ``ppermute``; at the
global image edges the halo is filled with the consuming op's own border
convention: the border row repeated ('edge', the stencils' clamp) or a
constant.
"""

from __future__ import annotations

import torch


def exchange_row_halo(x: torch.Tensor, up: int, down: int, group, fill="edge") -> torch.Tensor:
    """Extend a row shard [H_local, ...] with `up` rows from the shard above
    and `down` rows from the shard below."""
    idx, n = group.axis_index(), group.n
    parts = []
    if up:
        from_above = group.ppermute(x[-up:], [(i, (i + 1) % n) for i in range(n)])
        if idx == 0:
            from_above = (x[:1].expand(up, *x.shape[1:]) if fill == "edge"
                          else torch.full((up, *x.shape[1:]), fill, dtype=x.dtype,
                                          device=x.device))
        parts.append(from_above)
    parts.append(x)
    if down:
        from_below = group.ppermute(x[:down], [(i, (i - 1) % n) for i in range(n)])
        if idx == n - 1:
            from_below = (x[-1:].expand(down, *x.shape[1:]) if fill == "edge"
                          else torch.full((down, *x.shape[1:]), fill, dtype=x.dtype,
                                          device=x.device))
        parts.append(from_below)
    return torch.cat(parts, dim=0)


def exchange_width_halo(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Extend a width shard [H, W_local, ...] (axis 1) with `halo` columns
    from each neighbour.  Edge shards repeat their border column (the
    stencils' clamp at the true image boundary); interior seams receive the
    neighbours' columns."""
    idx, n = group.axis_index(), group.n
    left, right = group.ppermutes((x[:, -halo:], [(i, (i + 1) % n) for i in range(n)]),
                                  (x[:, :halo], [(i, (i - 1) % n) for i in range(n)]))
    if idx == 0:
        left = x[:, :1].expand(-1, halo, *x.shape[2:])
    if idx == n - 1:
        right = x[:, -1:].expand(-1, halo, *x.shape[2:])
    return torch.cat([left, x, right], dim=1)
