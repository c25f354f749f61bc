"""Run loop: frames from a source through the pipeline, plus the host step.

The synchronous form of the System loop (runtime/system.py), equal to
``System(max_in_flight=1)``: the eager step, then the host step of
cartslam_tpu/runtime/system.py (``_host_post_frame``): fetch each module's
host keys, call its ``host_update`` and merge the returned params (e.g. new
plane ``ranges``) into ``host_params``, so frame t+1 sees the params that
frame t's host step produced.  At the System's default of 4 frames in
flight they apply from frame t+4 instead, so the two differ there; the
System is the loop to build on (it captures the step on the card), this
loop is for tests and tools that want each frame's outputs as tensors.
With the context's ``grayscale`` switch, BGR frames are converted at the
source boundary, as cartslam_tpu/runtime/system.py does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ..sources.base import to_grayscale
from .pipeline import Pipeline


@dataclasses.dataclass
class RunResult:
    frames: int
    state: dict
    host_params: dict


def frame_to_device(frame: Mapping[str, Any], frame_id: int, device) -> dict:
    """Host frame dict (numpy images) -> tensors on `device` + frame_id."""
    out: dict[str, Any] = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in frame.items()
        if isinstance(v, np.ndarray)
    }
    out["frame_id"] = int(frame_id)
    return out


def host_step(
    pipeline: Pipeline,
    frame_id: int,
    outputs: Mapping[str, torch.Tensor],
    host_params: dict,
) -> dict:
    """Fetch host keys, run every module's host_update, merge new params."""
    for m in pipeline.modules:
        keys = [k for k in m.host_fetch_keys() if k in outputs]
        if not keys:
            continue
        fetched = {k: outputs[k].cpu().numpy() for k in keys}
        updated = m.host_update(pipeline.ctx, frame_id, fetched)
        if updated:
            host_params[m.name] = {**host_params.get(m.name, {}), **updated}
    return host_params


def run(
    pipeline: Pipeline,
    source,
    max_frames: int | None = None,
    on_frame: Callable[[int, dict], None] | None = None,
) -> RunResult:
    """Stream `source` through `pipeline` from a fresh state; frame ids are
    1-based."""
    state = pipeline.init_state()
    host_params = pipeline.init_host_params()
    frame_id = 0
    while not source.is_finished():
        if max_frames is not None and frame_id >= max_frames:
            break
        frame_np = source.get_next()
        if frame_np is None:
            break
        frame_id += 1
        if pipeline.ctx.grayscale:
            frame_np = to_grayscale(frame_np)
        frame = frame_to_device(frame_np, frame_id, pipeline.ctx.device)
        state, outputs = pipeline.step(
            state, frame, host_params, pipeline.variant(frame_id)
        )
        host_params = host_step(pipeline, frame_id, outputs, host_params)
        if on_frame is not None:
            on_frame(frame_id, outputs)
    return RunResult(frame_id, state, host_params)
