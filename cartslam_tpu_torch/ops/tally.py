"""Per-label tables (counterpart of cartslam_tpu/ops/tally.py).

The JAX package builds its per-label sums and table lookups from one-hot
matmuls, because scatters and gathers cost per index on the TPU.  On the GPU
the sums are the integer scatter-add kernels K2 and K4 (kernels/tally.py),
and a table lookup is a plain index.
"""

from __future__ import annotations

import torch


def table_gather(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """out[..., p] = table[..., labels[p]]: shape table.shape[:-1] + labels.shape."""
    out = table[..., labels.reshape(-1).to(torch.int64)]
    return out.reshape(*table.shape[:-1], *labels.shape)
