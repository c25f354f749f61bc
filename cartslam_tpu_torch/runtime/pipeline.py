"""Pipeline composer (counterpart of cartslam_tpu/runtime/pipeline.py).

``step(state, frame, host_params, variant) -> (state, outputs)`` keeps the
JAX package's pure shape: it reads the old state and returns a new one.
PyTorch runs eagerly, so there is no jit; each module's ``compute`` runs in
topological order on the context's device.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from .module import Module, PipelineContext, StepContext


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

    def step(
        self,
        state: Mapping[str, Any],
        frame: Mapping[str, Any],
        host_params: Mapping[str, Any],
        variant: tuple,
        spatial=None,
    ) -> tuple[dict, dict[str, torch.Tensor]]:
        """One frame: returns (new_state, outputs of every module).  With a
        SpatialContext, every module runs its ``compute_spatial`` on this
        shard's rows (parallel/spatial_flagship.py)."""
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
                    host_params.get(m.name, {}), var)
            if spatial is None:
                outputs, mstate = m.compute(*args)
            else:
                outputs, mstate = m.compute_spatial(*args, spatial)
            new_mod_state[m.name] = mstate
            available.update(outputs)

        new_history = {}
        for key in self.history_depth:
            ring = state["history"][key]
            cur = available[key][None].to(ring.dtype)
            new_history[key] = torch.cat([cur, ring[:-1]], dim=0)
        return {"modules": new_mod_state, "history": new_history}, available
