"""Pipeline composer (counterpart of cartslam_tpu/runtime/pipeline.py).

``step(state, frame, host_params, variant) -> (state, outputs)`` keeps the
JAX package's pure shape: it reads the old state and returns a new one.
PyTorch runs eagerly: each module's ``compute`` runs in topological order
on the context's device.  ``captured_step(variant, fetch_keys)`` is the
counterpart of ``jitted_step``: the same step captured once into a CUDA
graph (runtime/graphs.py) and replayed.  ``run_step_instrumented`` runs
module by module with a sync after each, for per-module timing rows.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Hashable, Mapping

import torch

from .module import Module, PipelineContext, StepContext
from .state import host_to_device


class PipelineError(RuntimeError):
    pass


def _toposort(modules: list[Module]) -> list[Module]:
    provided_by: dict[str, Module] = {}
    for m in modules:
        for key in m.provides():
            if key in provided_by:
                raise PipelineError(
                    f"key '{key}' provided by both {provided_by[key].name} and {m.name}"
                )
            provided_by[key] = m

    for m in modules:
        for dep in m.requires():
            if dep.optional:
                continue
            if dep.key not in provided_by:
                raise PipelineError(
                    f"module {m.name} requires '{dep.key}' which no module provides"
                )

    order: list[Module] = []
    temp: set[int] = set()
    done: set[int] = set()

    def visit(m: Module):
        mid = id(m)
        if mid in done:
            return
        if mid in temp:
            raise PipelineError(f"dependency cycle involving module {m.name}")
        temp.add(mid)
        for dep in m.requires():
            if dep.offset == 0 and dep.key in provided_by:
                visit(provided_by[dep.key])
        temp.discard(mid)
        done.add(mid)
        order.append(m)

    for m in modules:
        visit(m)
    return order


class Pipeline:
    """Composes modules into one step function with explicit state."""

    def __init__(self, ctx: PipelineContext, modules: list[Module]):
        self.ctx = ctx
        self.modules = _toposort(modules)
        self._specs = {}
        for m in self.modules:
            self._specs.update(m.output_spec(ctx))

        # History requirements: key -> max depth.
        self.history_depth: dict[str, int] = {}
        for m in self.modules:
            for dep in m.requires():
                if dep.offset < 0:
                    d = self.history_depth.get(dep.key, 0)
                    self.history_depth[dep.key] = max(d, -dep.offset)
        for key in self.history_depth:
            if key not in self._specs:
                raise PipelineError(f"history of unknown key '{key}' requested")
        self._static = None  # graphs.StaticBuffers, made at the first capture
        # (variant, fetch keys) -> graphs.CapturedStep (its capture_s, launches)
        self.captured_steps: dict[tuple[Hashable, frozenset], Any] = {}

    @property
    def devices(self) -> list[torch.device]:
        """The devices the step runs on: the context's."""
        return [self.ctx.device]

    def on_device(self, device) -> "Pipeline":
        """The same pipeline built anew on `device`, the modules copied (a
        module's device constants are made for the device it runs on, and
        its caches name their device), as a partition of the
        multi-sequence System needs."""
        return Pipeline(dataclasses.replace(self.ctx, device=device),
                        copy.deepcopy(self.modules))

    def init_state(self) -> dict:
        mod_state = {m.name: m.init_state(self.ctx) for m in self.modules}
        history = {}
        for key, depth in self.history_depth.items():
            spec = self._specs[key]
            history[key] = torch.zeros(
                (depth, *spec.shape), dtype=spec.dtype, device=self.ctx.device
            )
        return {"modules": mod_state, "history": history}

    def init_host_params(self) -> dict:
        return {m.name: m.initial_host_params(self.ctx) for m in self.modules}

    def host_fetch_keys(self) -> set[str]:
        keys: set[str] = set()
        for m in self.modules:
            keys.update(m.host_fetch_keys())
        return keys

    def variant(self, frame_id: int) -> tuple:
        return tuple(m.variant(frame_id) for m in self.modules)

    def device_params(self, host_params: Mapping[str, Any]) -> dict:
        """Host params {module: {key: array}} as tensors on the context's
        device (tensors already there pass as they are).  The step reads
        its params from the device, so the host step writes them there
        once per change, not once per frame."""
        dev = self.ctx.device
        return {name: {k: v if isinstance(v, torch.Tensor) and v.device == dev
                       else host_to_device(v, dev) for k, v in p.items()}
                for name, p in host_params.items()}

    def prepare(self, frame: Mapping[str, Any], host_params: Mapping[str, Any]):
        """(frame, params) as the step body takes them: the frame id an
        int32 scalar on the device (made by a fill, no host copy), the
        params device tensors.  Inputs already in that form pass through."""
        fid = frame["frame_id"]
        if not isinstance(fid, torch.Tensor):
            frame = {**frame, "frame_id": torch.full((), int(fid), dtype=torch.int32,
                                                     device=self.ctx.device)}
        return frame, self.device_params(host_params)

    def step(
        self,
        state: Mapping[str, Any],
        frame: Mapping[str, Any],
        host_params: Mapping[str, Any],
        variant: tuple,
        spatial=None,
    ) -> tuple[dict, dict[str, torch.Tensor]]:
        """One frame, eagerly: returns (new_state, outputs of every module).
        With a SpatialContext, every module runs its ``compute_spatial`` on
        this shard's rows (parallel/spatial_flagship.py)."""
        frame, params = self.prepare(frame, host_params)
        return self.compute_step(state, frame, params, variant, spatial)

    def compute_step(self, state, frame, params, variant: tuple, spatial=None,
                     on_module=None) -> tuple[dict, dict[str, torch.Tensor]]:
        """The step body on device inputs only (``prepare``'s form): it
        reads nothing back to the host and copies nothing to the device,
        so it runs eagerly or under CUDA graph capture alike.  on_module:
        called with each module before its compute and after it (with
        the outputs), for instrumented runs."""
        step_ctx = StepContext(frame, state["history"])
        available: dict[str, torch.Tensor] = {}
        new_mod_state = {}
        for m, var in zip(self.modules, variant):
            deps: dict[str, torch.Tensor] = {}
            for dep in m.requires():
                if dep.offset == 0:
                    if dep.key in available:
                        deps[dep.key] = available[dep.key]
                    elif not dep.optional:
                        raise PipelineError(f"{m.name}: '{dep.key}' not computed yet")
            args = (self.ctx, step_ctx, deps, state["modules"].get(m.name, {}),
                    params.get(m.name, {}), var)
            if on_module is not None:
                on_module(m, None)
            if spatial is None:
                outputs, mstate = m.compute(*args)
            else:
                outputs, mstate = m.compute_spatial(*args, spatial)
            if on_module is not None:
                on_module(m, outputs)
            new_mod_state[m.name] = mstate
            available.update(outputs)

        new_history = {}
        for key in self.history_depth:
            ring = state["history"][key]
            cur = available[key][None].to(ring.dtype)
            new_history[key] = torch.cat([cur, ring[:-1]], dim=0)
        return {"modules": new_mod_state, "history": new_history}, available

    # ------------------------------------------------------ captured step

    def static_buffers(self, frame: Mapping[str, Any] | None = None):
        """The device buffers every captured variant reads and writes
        (runtime/graphs.StaticBuffers): made at the first call, which needs
        an example host frame for the images' shapes, from the pipeline's
        initial state and host params."""
        if self._static is None:
            if frame is None:
                raise ValueError("the first static_buffers call needs an example frame")
            from .graphs import StaticBuffers

            self._static = StaticBuffers(self, frame)
        return self._static

    def captured_step(self, variant: tuple, fetch_keys: frozenset[str]):
        """The step of `variant` captured into a CUDA graph over the static
        buffers, returning the fetch keys' outputs: the counterpart of
        ``jitted_step``.  Cached per (variant, fetch_keys), as JAX caches
        its jitted steps, but on the instance, so the graphs and their
        memory go with the pipeline.  A failed capture raises
        (graphs.CaptureError); there is no eager fallback."""
        key = (variant, frozenset(fetch_keys))
        step = self.captured_steps.get(key)
        if step is None:
            from .graphs import CapturedStep

            step = self.captured_steps[key] = CapturedStep(self, self.static_buffers(), variant,
                                                      key[1])
        return step

    # ------------------------------------------------- instrumented step

    def run_step_instrumented(self, state, frame, host_params, variant: tuple,
                              fetch_keys: frozenset[str] | None = None):
        """One frame module by module with a sync after each module: the
        per-module timing mode, the counterpart of the reference's
        per-module CSV rows (src/cartslam.cpp:259-291).  ``init`` = module
        submitted, ``start`` = its dependencies done on the device,
        ``end`` = its outputs done.  Slower than the fused step; use it to
        attribute time, not to measure throughput.

        Returns (new_state, outputs, timings) with timings a list of
        (module_name, init_s, start_s, end_s) perf_counter seconds."""
        frame, params = self.prepare(frame, host_params)
        dev = self.ctx.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        timings: list[tuple[str, float, float, float]] = []
        marks: dict[str, float] = {}

        def on_module(m, outputs):
            if outputs is None:
                marks["init"] = time.perf_counter()
                sync()
                marks["start"] = time.perf_counter()
            else:
                sync()
                timings.append((m.name, marks["init"], marks["start"], time.perf_counter()))

        new_state, available = self.compute_step(state, frame, params, variant,
                                                 on_module=on_module)
        outputs = (available if fetch_keys is None
                   else {k: v for k, v in available.items() if k in fetch_keys})
        return new_state, outputs, timings
