"""Per-label tables (counterpart of cartslam_tpu/ops/tally.py).

The JAX package builds its per-label sums and table lookups from one-hot
matmuls, because scatters and gathers cost per index on the TPU.  On the GPU
the sums are the integer scatter-add kernels K2, K4 and K7
(kernels/tally.py), and a table lookup is a plain index.
"""

from __future__ import annotations

import torch

from ..kernels import tally as ktally


def label_tally(labels: torch.Tensor, values: torch.Tensor, num_labels: int,
                reduce=None) -> torch.Tensor:
    """Per-label sums out[l, c] = sum of values[b, c] over labels[b] == l:
    float32 [L, C] from labels int [B] and integer values [B, C] (kernel
    K7).  Each entry is the exact integer sum, rounded to float32 once;
    labels outside [0, L) drop.  reduce: applied to the int64 sums (the
    kernel's channel-major [C, L] table) before the rounding (the spatial
    mode's psum).  The kernel reads the values channel-major: the transposes
    to and from it are this function's."""
    table = ktally.label_tally(labels.reshape(-1).to(torch.int32).contiguous(),
                               values.to(torch.int32).T.contiguous(), num_labels, reduce)
    return table.T.contiguous()


def table_gather(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """out[..., p] = table[..., labels[p]]: shape table.shape[:-1] + labels.shape.
    Labels outside [0, L) (the spatial mode's -1 halo fill) read zeros, not
    a wrapped-around entry."""
    idx = labels.reshape(-1).to(torch.int64)
    num = table.shape[-1]
    inb = (idx >= 0) & (idx < num)
    out = table[..., idx.clamp(0, num - 1)].masked_fill(~inb, 0)
    return out.reshape(*table.shape[:-1], *labels.shape)
