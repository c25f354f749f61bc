"""Disparity -> 3D reprojection via the OpenCV Q matrix (counterpart of
ops/depth.py).

Invalid disparities (-32768/16) go through the same math, as in the
reference.  Each output row of Q is applied as
``((q0*x + q1*y) + q2*d) + q3``, in float32; the JAX package's einsum may sum
in another order (or fuse multiply-adds), so the two agree within a few ulp.
"""

from __future__ import annotations

import torch


def reproject_to_3d(disparity: torch.Tensor, q, row_offset: int = 0) -> torch.Tensor:
    """int16 x16 disparity [H,W] + Q [4,4] -> XYZ float32 [H,W,3].
    row_offset: global row of the first row (height-sharded mode).  A Q
    already on the disparity's device as float32 (PipelineContext.q_tensor)
    is used as it is: no host copy."""
    h, w = disparity.shape
    dev = disparity.device
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    d = disparity.to(torch.float32) / 16.0
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ys = torch.arange(row_offset, row_offset + h, dtype=torch.float32,
                      device=dev)[:, None].expand(h, w)
    out = [q[i, 0] * xs + q[i, 1] * ys + q[i, 2] * d + q[i, 3] for i in range(4)]
    return torch.stack(out[:3], dim=-1) / out[3][..., None]
