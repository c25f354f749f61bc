"""Multi-sequence lock-step batching (counterpart of cartslam_tpu/parallel/
multiseq.py).

B independent video sequences advance in lock-step through one pipeline.
JAX vmaps the step over a leading [B] axis of the state and the frame, with
the host params shared (``in_axes=(0, 0, None)``).  The port's form of that
vmap is a loop: sequence b's step on slice b of the state and the frame,
the results stacked.  (``torch.func.vmap`` cannot see through the ctypes
kernels; the kernels stay per frame, as JAX's vmap adds the batch outside
the Pallas kernels' bodies.)  On the card the multi-sequence System captures
the B steps into one CUDA graph, each on a stream of its own
(runtime/graphs.py).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..runtime.state import map_tree, stack_trees


def _round_id(frame_id, device) -> torch.Tensor:
    """The round's id as the int32 device scalar every sequence reads.  JAX
    gives [B] equal values; the first stands for all."""
    if isinstance(frame_id, torch.Tensor):
        return frame_id.reshape(-1)[0] if frame_id.dim() else frame_id
    return torch.full((), int(np.asarray(frame_id).reshape(-1)[0]), dtype=torch.int32,
                      device=device)


def batched_step(pipeline, state, frame: Mapping[str, Any], host_params, variant,
                 keys=None) -> tuple[dict, dict[str, torch.Tensor]]:
    """One round, eagerly: sequence b's ``pipeline.step`` (a Pipeline's or a
    SpatialPipeline's) on slice b of `state` and of `frame`'s images, one
    sequence after another on the current stream, with the shared host
    params.  Returns (new state, outputs), each leaf stacked over the
    sequences; `keys` limits the outputs stacked."""
    dev = pipeline.ctx.device
    fid = _round_id(frame["frame_id"], dev)
    images = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)).to(dev)
              for k, v in frame.items() if k != "frame_id"}
    params = pipeline.device_params(host_params)
    batch = next(iter(images.values())).shape[0]
    results = [pipeline.step(map_tree(lambda t: t[b], state),
                             {**{k: v[b] for k, v in images.items()}, "frame_id": fid},
                             params, variant)
               for b in range(batch)]
    new_state = stack_trees([r[0] for r in results])
    outputs = {k: torch.stack([r[1][k] for r in results])
               for k in results[0][1] if keys is None or k in keys}
    return new_state, outputs


def make_batched_step(pipeline, batch: int, variant_frame: int = 2):
    """Returns (batched_step, init_state_fn, init_params_fn), as the JAX
    function does.

    batched_step(state, frame, host_params) -> (state, outputs), every leaf
    with a leading [batch] axis, the host params shared by the batch; the
    variant is that of frame `variant_frame`.  init_state_fn() gives the
    pipeline's initial state stacked `batch` times on its device."""
    variant = pipeline.variant(variant_frame)

    def step(state, frame, host_params):
        return batched_step(pipeline, state, frame, host_params, variant)

    def init_state():
        return stack_trees([pipeline.init_state()] * batch)

    def init_params():
        return pipeline.init_host_params()

    return step, init_state, init_params
