"""Height-sharded pipeline (counterpart of cartslam_tpu/parallel/
spatial_flagship.py ``SpatialPipeline``).

One frame's rows are split over n shards, and the configured module list
runs on every shard through each module's ``compute_spatial``: ``ppermute``
row halos stand in for the reference's tiled shared-memory aprons and
``psum`` for its global reductions (label statistics, vote tallies,
histograms).  The stage math is the production ``Pipeline``'s: the shard
step is ``Pipeline.compute_step`` over the same modules with a SpatialContext.
Seams, module by module:

  * SGM (models/disparity.py): bit-exact for any shard count; horizontal
    sweeps are row-local, the vertical ones run the split-scan carry chain
    (parallel/sgm_sharded.py, kernel K5 on the card).
  * interpolation / derivative: edge-duplicated halos, one exchange per
    smoothing iteration; exact.
  * optical flow (models/optflow.py): 'global' gathers the gray pair and
    runs the full pyramid (bit-exact); 'sharded' runs per-shard apron
    pyramids (approximate).
  * contour relaxation (models/superpixels.py): `iterations`-row halos and
    psum'd label moments; exact.
  * temporal vote (models/sp_planeseg.py): `max_warp_y`-row halos of the
    vote stack and the 'select' warp; exact for bounded warps.

The shards run as threads of a ShardGroup (parallel/group.py), in this
version all on the pipeline's one device.  State and outputs are
full-height tensors, as shard_map's global arrays are: the step narrows
each shard's rows out of them, runs the shards, and concatenates the
results, so the run loop, ``state_from_reference`` and ``state_to_numpy``
work unchanged.  Halos must fit in one neighbour shard (each module's
``spatial_validate`` checks its own).

``step`` is ``prepare`` plus ``compute_step``, the device-only body (shard
narrowing, the shards' run, the merge), as ``Pipeline``'s.
``captured_step(variant, fetch_keys)`` is the counterpart of
``jitted_step``: that body captured once per (variant, fetch keys) into a
CUDA graph over the pipeline's static buffers (runtime/graphs.py) and
replayed, the 8 shard threads' launches of a frame leaving the host as one
replay.  Its graphs' launches are the eager frame's.
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import torch

from ..runtime.module import PipelineContext, SpatialContext
from ..runtime.pipeline import Pipeline
from .group import ShardGroup


def _infer_row_dim(shape, height: int) -> int | None:
    """First dimension whose extent equals the global image height: state
    leaves and outputs split over the shards there; tensors without one
    stay whole (replicated)."""
    for i, s in enumerate(shape):
        if s == height:
            return i
    return None


class SpatialPipeline:
    """Pipeline-compatible height-sharded composer over real modules: the
    surface the System, `runtime/loop.run` and `host_step` drive (ctx,
    modules, init_state, init_host_params, device_params, host_fetch_keys,
    variant, step, compute_step, static_buffers, captured_step)."""

    # The captured step is Pipeline's over this pipeline's compute_step: the
    # static buffers of the full-height state tree, and one CapturedStep per
    # (variant, fetch keys) cached on the instance.
    static_buffers = Pipeline.static_buffers
    captured_step = Pipeline.captured_step

    def __init__(self, ctx: PipelineContext, modules, n: int):
        self.ctx = ctx
        self.inner = Pipeline(ctx, modules)
        self.modules = self.inner.modules
        self.n = n
        if ctx.height % n:
            raise ValueError(f"height {ctx.height} must divide the {n}-way spatial axis")
        self.h_local = ctx.height // n
        self.group = ShardGroup(n, [ctx.device] * n)
        self.sp = SpatialContext(self.group, self.h_local)
        self._provider = {}
        for m in self.modules:
            if not m.supports_spatial():
                raise ValueError(
                    f"module {m.name} does not support the spatial latency mode "
                    "(no compute_spatial); run it in single-chip or multiseq mode"
                )
            m.spatial_validate(ctx, n, self.h_local)
            for key in m.provides():
                self._provider[key] = m
        self._row_dims = self._state_row_dims()
        self._static = None  # graphs.StaticBuffers, made at the first capture
        self.captured_steps: dict = {}  # (variant, fetch keys) -> graphs.CapturedStep

    # ------------------------------------------------- Pipeline interface

    def host_fetch_keys(self):
        return self.inner.host_fetch_keys()

    def init_state(self):
        return self.inner.init_state()

    def init_host_params(self):
        return self.inner.init_host_params()

    def device_params(self, host_params):
        return self.inner.device_params(host_params)

    def variant(self, frame_id: int) -> tuple:
        return self.inner.variant(frame_id)

    def run_step_instrumented(self, state, frame, host_params, variant,
                              fetch_keys: frozenset[str] | None = None):
        """The module-timing mode's step: the spatial step is one program
        over the shards, so there is no per-module attribution; one
        'spatial_step' row a frame (the JAX method's row), ended by a sync
        on a card.  Returns (new_state, outputs, timings) as
        ``Pipeline.run_step_instrumented``."""
        t0 = time.perf_counter()
        new_state, outputs = self.step(state, frame, host_params, variant)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        t1 = time.perf_counter()
        if fetch_keys is not None:
            outputs = {k: v for k, v in outputs.items() if k in fetch_keys}
        return new_state, outputs, [("spatial_step", t0, t0, t1)]

    # ------------------------------------------------------ row dimensions

    def _output_row_dim(self, key: str) -> int | None:
        m = self._provider[key]
        over = m.spatial_row_dims(self.ctx)
        if key in over:
            return over[key]
        spec = m.output_spec(self.ctx).get(key)
        return None if spec is None else _infer_row_dim(spec.shape, self.ctx.height)

    def _state_row_dims(self) -> dict:
        mods = {}
        for m in self.modules:
            over = m.spatial_row_dims(self.ctx)
            mods[m.name] = {k: over.get(k, _infer_row_dim(v.shape, self.ctx.height))
                            for k, v in m.init_state(self.ctx).items()}
        hist = {}
        for key in self.inner.history_depth:
            rd = self._output_row_dim(key)
            hist[key] = None if rd is None else rd + 1
        return {"modules": mods, "history": hist}

    # ---------------------------------------------------------------- step

    def _rows(self, x: torch.Tensor, rd: int | None, i: int) -> torch.Tensor:
        if rd is None:
            return x
        return x.narrow(rd, i * self.h_local, self.h_local).contiguous()

    def _shard_state(self, state, i: int) -> dict:
        rd = self._row_dims
        return {
            "modules": {name: {k: self._rows(v, rd["modules"][name][k], i)
                               for k, v in mstate.items()}
                        for name, mstate in state["modules"].items()},
            "history": {k: self._rows(v, rd["history"][k], i)
                        for k, v in state["history"].items()},
        }

    def _shard_frame(self, frame: Mapping[str, Any], i: int) -> dict:
        h = self.ctx.height
        return {k: self._rows(v, 0, i)
                if isinstance(v, torch.Tensor) and v.dim() >= 2 and v.shape[0] == h else v
                for k, v in frame.items()}

    def _merge(self, parts: list, rd: int | None) -> torch.Tensor:
        return parts[0] if rd is None else torch.cat(parts, dim=rd)

    def step(self, state, frame, host_params, variant) -> tuple[dict, dict]:
        """One frame on n row shards, eagerly: (new full-height state,
        full-height outputs)."""
        frame, params = self.inner.prepare(frame, host_params)
        return self.compute_step(state, frame, params, variant)

    def compute_step(self, state, frame, params, variant) -> tuple[dict, dict]:
        """The step body on device inputs only (``Pipeline.prepare``'s form):
        each shard's rows narrowed out of the full-height state and frame,
        the shards run (their threads enqueue on the caller's current
        stream, the capture stream under capture), the results merged.  It
        reads nothing back to the host and copies nothing in, so it runs
        eagerly or under CUDA graph capture alike.  Replicated keys (the
        histogram, superpixels_max_label) come from shard 0."""

        def shard(i: int):
            return self.inner.compute_step(self._shard_state(state, i),
                                           self._shard_frame(frame, i), params, variant,
                                           spatial=self.sp)

        results = self.group.run(shard)
        rd = self._row_dims
        new_state = {
            "modules": {name: {k: self._merge([r[0]["modules"][name][k] for r in results],
                                              rd["modules"][name][k])
                               for k in mstate}
                        for name, mstate in results[0][0]["modules"].items()},
            "history": {k: self._merge([r[0]["history"][k] for r in results],
                                       rd["history"][k])
                        for k in results[0][0]["history"]},
        }
        outputs = {k: self._merge([r[1][k] for r in results], self._output_row_dim(k))
                   for k in results[0][1]}
        return new_state, outputs
