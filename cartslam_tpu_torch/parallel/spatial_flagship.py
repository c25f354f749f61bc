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

The shards run as threads of a ShardGroup (parallel/group.py), placed on
the visible cards in contiguous blocks as JAX places shard i on
``jax.devices()[i]``: shard i on card floor(i k / n) of k, so on one card
every shard shares it.  State and outputs are full-height tensors on the
pipeline's device, as shard_map's global arrays are: the step narrows each
shard's rows out of them (onto the shard's card), runs the shards, and
concatenates the results (back on the pipeline's device), so the run loop,
``state_from_reference`` and ``state_to_numpy`` work unchanged.  Halos
must fit in one neighbour shard (each module's ``spatial_validate`` checks
its own).

``step`` is ``prepare`` plus ``compute_step``, the device-only body (shard
narrowing, the shards' run, the merge), as ``Pipeline``'s.
``captured_step(variant, fetch_keys)`` is the counterpart of
``jitted_step``: that body captured once per (variant, fetch keys) into a
CUDA graph over the pipeline's static buffers (runtime/graphs.py) and
replayed, the 8 shard threads' launches of a frame leaving the host as one
replay.  Its graphs' launches are the eager frame's.  Only a pipeline whose
shards share its card is captured (``capturable``): PyTorch's graph memory
pool is per device, so across cards the System runs the step eagerly.

``SpatialFlagshipConfig`` / ``SpatialFlagship`` are the preset that builds
the flagship's six modules from knobs, without a JSON config.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

from ..runtime.module import PipelineContext, SpatialContext
from ..runtime.pipeline import Pipeline
from .distributed import canonical_device, local_devices
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

    def __init__(self, ctx: PipelineContext, modules, n: int, devices=None,
                 streams: str = "shared"):
        """`devices`: the cards the n shards are placed on in contiguous
        blocks (default: every visible device of the context's type);
        `streams`: "per_shard" gives every shard a stream of its own on one
        card too, with the collectives as event joins (parallel/group.py)."""
        self.ctx = ctx
        self.inner = Pipeline(ctx, modules)
        self.modules = self.inner.modules
        self.n = n
        if ctx.height % n:
            raise ValueError(f"height {ctx.height} must divide the {n}-way spatial axis")
        self.h_local = ctx.height // n
        cards = [canonical_device(d) for d in devices] if devices is not None \
            else local_devices(ctx.device.type)
        self.group = ShardGroup(n, [cards[i * len(cards) // n] for i in range(n)],
                                streams=streams)
        home = canonical_device(ctx.device)
        self.capturable = set(self.group.devices) == {home}
        # A shard's modules run with a context on its own card (its
        # constants, e.g. Q, live there).
        self._shard_pipes = {d: self.inner if d == home else
                             Pipeline(dataclasses.replace(ctx, device=d), self.modules)
                             for d in set(self.group.devices)}
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

    def on_device(self, device, shard_devices) -> "SpatialPipeline":
        """The same pipeline built anew with `device` as its device and its
        shards on `shard_devices` (one each): the modules are copied before
        the copy makes its device constants, as a partition of the
        multi-sequence System needs."""
        return SpatialPipeline(dataclasses.replace(self.ctx, device=device),
                               copy.deepcopy(self.modules), self.n, shard_devices,
                               self.group.streams)

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
        """Shard i's rows of x (all of x without a row dimension), on its
        device (no copy when that is x's)."""
        if rd is not None:
            x = x.narrow(rd, i * self.h_local, self.h_local).contiguous()
        return x.to(self.group.devices[i], non_blocking=True)

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
        return {k: self._rows(v, 0 if v.dim() >= 2 and v.shape[0] == h else None, i)
                if isinstance(v, torch.Tensor) else v
                for k, v in frame.items()}

    def _merge(self, parts: list, rd: int | None) -> torch.Tensor:
        parts = [p.to(self.ctx.device, non_blocking=True) for p in parts]
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
            dev = self.group.devices[i]
            return self._shard_pipes[dev].compute_step(
                self._shard_state(state, i), self._shard_frame(frame, i),
                {name: {k: v.to(dev, non_blocking=True) for k, v in p.items()}
                 for name, p in params.items()}, variant, spatial=self.sp)

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


class SpatialFlagshipConfig(NamedTuple):
    """Knob bundle of the flagship preset (the JAX class's knobs and
    defaults): benchmarks and parity tests build the height-sharded chain
    from it without a JSON config.  The config path (config/registry.py)
    builds SpatialPipeline from the configured modules and does not use it."""

    height: int
    width: int
    num_disparities: int = 256
    min_disparity: int = 4
    sgm_p1: int = 10
    sgm_p2: int = 120
    uniqueness: int = 12
    smoothing_radius: int = 2
    smoothing_iterations: int = 1
    block_size: int = 12
    iterations: int = 8
    initial_iterations: int = 24
    reset_iterations: int = 64
    image_weight: float = 1.5
    disparity_weight: float = 1.0
    compactness_weight: float = 0.1
    progressive_compactness_cost: float = 0.0
    direct_clique_cost: float = 0.5
    diagonal_clique_cost: float = 0.5 / np.sqrt(2.0)
    relax_phases: int = 1
    stats_refresh: str = "frame"
    temporal_distance: int = 3
    max_warp_y: int = 32
    max_warp_x: int = 64
    flow_levels: int = 4
    flow_search: int = 4
    flow_refine: int = 2
    flow_base_level: int = 1
    flow_med_passes: int = 2
    # Unused since the exact split-scan seams (parallel/sgm_sharded.py);
    # kept so the JAX package's configs and keywords load.
    sgm_halo: int = 24
    # The 'sharded' flow's apron rows (flow_mode='sharded' only).
    flow_halo: int = 46
    flow_mode: str = "global"
    grayscale: bool = False
    # The JAX mesh axis name; a ShardGroup has no axis names.
    axis: str = "spatial"


class SpatialFlagship:
    """The flagship preset as a ready-made SpatialPipeline of `n` shards:
    the six modules the single-card flagship runs (disparity -> derivative
    -> depth -> flow -> superpixels -> superpixel planeseg with a static
    provider over `ranges` and the carried temporal vote in 'select' warp
    mode), the counterpart of the JAX class over a mesh of n devices.
    `device`, `devices` and `streams` as SpatialPipeline's."""

    def __init__(self, config: SpatialFlagshipConfig, n: int, q=None,
                 ranges=((3, 40), (-6, 3)), *, device="cuda", devices=None,
                 streams: str = "shared"):
        from .. import models
        from ..utils.plane_params import StaticPlaneParameterProvider

        c = config
        self.cfg = c
        ctx = PipelineContext(height=c.height, width=c.width,
                              q=np.asarray(np.eye(4) if q is None else q, np.float32),
                              device=device, grayscale=c.grayscale)
        sup = models.SuperPixelModule(
            (c.height, c.width), initial_iterations=c.initial_iterations,
            iterations=c.iterations, block_size=c.block_size,
            reset_iterations=c.reset_iterations, direct_clique_cost=c.direct_clique_cost,
            diagonal_clique_cost=c.diagonal_clique_cost,
            compactness_weight=c.compactness_weight,
            progressive_compactness_cost=c.progressive_compactness_cost,
            image_weight=c.image_weight, disparity_weight=c.disparity_weight,
            relax_phases=c.relax_phases, stats_refresh=c.stats_refresh)
        modules = [
            models.ImageDisparityModule(
                (c.height, c.width), min_disparity=c.min_disparity,
                num_disparities=c.num_disparities, smoothing_radius=c.smoothing_radius,
                smoothing_iterations=c.smoothing_iterations, p1=c.sgm_p1, p2=c.sgm_p2,
                uniqueness=c.uniqueness),
            models.ImageDisparityDerivativeModule(),
            models.DepthModule(),
            models.ImageOpticalFlowModule(
                (c.height, c.width), levels=c.flow_levels, search=c.flow_search,
                refine=c.flow_refine, base_level=c.flow_base_level,
                med_passes=c.flow_med_passes, spatial_mode=c.flow_mode,
                spatial_halo=c.flow_halo),
            sup,
            models.SuperPixelDisparityPlaneSegmentationModule(
                StaticPlaneParameterProvider(*ranges), num_labels=sup.num_labels,
                use_temporal_smoothing=True, temporal_smoothing_distance=c.temporal_distance,
                warp_mode="select", max_warp_y=c.max_warp_y, max_warp_x=c.max_warp_x),
        ]
        self.pipeline = SpatialPipeline(ctx, modules, n, devices, streams)
        self.h_local = self.pipeline.h_local
        self.max_label_id = sup.max_label_id
        self.num_labels = sup.num_labels

    # ------------------------------------------------------------- surface

    def init_state(self):
        return self.pipeline.init_state()

    def init_params(self):
        return self.pipeline.init_host_params()

    def variant(self, frame_id: int) -> tuple:
        return self.pipeline.variant(frame_id)

    def _variant_arg(self, variant):
        if variant is None:
            variant = "normal"
        if isinstance(variant, str):
            fid = {"initial": 1, "reset": self.cfg.reset_iterations,
                   "normal": self.cfg.reset_iterations + 1}[variant]
            return self.pipeline.variant(fid)
        return variant

    def make_step(self, variant=None):
        """step(state, frame, host_params) -> (state, outputs) of one
        variant ('initial', 'normal', 'reset' or a variant tuple), the
        counterpart of the JAX ``make_step``: on a card the captured step
        (the inputs copied into its static buffers, its CUDA graph replayed;
        the returned tensors are those buffers, valid until its next call),
        on the CPU (or across cards) the eager step."""
        return self._step(self._variant_arg(variant), None)

    def make_batched_step(self, batch: int, variant=None):
        """The composed step of `batch` sequences, every leaf of the state,
        the frame and the outputs with a leading [batch] axis and the host
        params shared: the counterpart of ``make_batched_step``, captured on
        a card as the SpatialMultiSeqSystem's (one graph holding the
        sequences' steps, each on a stream of its own)."""
        return self._step(self._variant_arg(variant), batch)

    def _step(self, variant, batch: int | None):
        from ..runtime.graphs import CapturedStep, StaticBuffers
        from .multiseq import batched_step

        pipe = self.pipeline
        keys = frozenset(k for m in pipe.modules for k in m.provides())
        made: dict = {}

        def step(state, frame, host_params):
            if not (pipe.ctx.device.type == "cuda" and pipe.capturable):
                if batch is None:
                    return pipe.step(state, frame, host_params, variant)
                return batched_step(pipe, state, frame, host_params, variant)
            images = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
                      for k, v in frame.items() if k != "frame_id"}
            if not made:
                example = {k: np.empty(tuple(v.shape), torch.empty(0, dtype=v.dtype).numpy().dtype)
                           for k, v in images.items()}
                made["buffers"] = StaticBuffers(pipe, example, batch)
            bufs = made["buffers"]
            bufs.load_state(state)
            bufs.load_params(host_params)
            bufs.load_frame(images, int(torch.as_tensor(frame["frame_id"]).reshape(-1)[0]))
            if "graph" not in made:
                made["graph"] = CapturedStep(pipe, bufs, variant, keys)
            return bufs.state, made["graph"]()

        return step
