"""MultiSeqSystem: B sequences in lock-step through one pipeline on one card
(counterpart of cartslam_tpu/parallel/system.py).

The multi-sequence throughput mode (config: ``{"parallel": {"mode":
"multiseq", "batch": B}}``): B independent sequences advance in lock-step,
one round a frame of each.  JAX vmaps the step over the batch and shards the
batch over a device mesh; here the B sequences share one card.  On the card
each round is one replay of a CUDA graph that holds all B sequences' steps,
each on a stream of its own (runtime/graphs.py, ``StaticBuffers(...,
batch=B)``), a Pipeline's or a SpatialPipeline's; a CPU context runs the
eager batched step (parallel/multiseq.batched_step).

Everything else is the single-sequence System's (runtime/system.py): the
pinned prefetch (of the stacked frames), the pinned fetch slots and fetch
threads under the data watchdog, the drain order (so the host params lag as
in the JAX class), failed-round recovery from the last proven-good snapshot,
and checkpoints, in the JAX batched layout (batch-leading leaves and each
module's host state).  A resume skips every source to the saved round.

The host params are shared by the batch.  Host-fetched keys are reduced as
each module declares (``Module.host_fetch_reduce``): 'sum' keys (the
histograms) are summed over the batch before the provider's update, the
scale-out counterpart of the reference's one shared provider
(planeseg.cu:269-288); an undeclared key falls back to sequence 0 with a
one-time warning.  Host modules process and render sequence 0.
"""

from __future__ import annotations

import logging
from typing import Iterable

import numpy as np
import torch

from ..runtime.graphs import CapturedStep, StaticBuffers
from ..runtime.module import HostModule
from ..runtime.system import System
from ..runtime.timing import TimingWriter
from ..sources.base import to_grayscale
from ..runtime.state import stack_trees
from .multiseq import batched_step

log = logging.getLogger("cart.multiseq")


class MultiSeqSystem(System):
    """Drives B sources through one pipeline in lock-step.

    Args (the JAX class's, without its device mesh: the pipeline's one
    device runs every sequence):
        sources: exactly B DataSources; the run ends when any source is
            exhausted.
        pipeline: the shared Pipeline.
        data_timeout: seconds before a hung result fetch raises
            DataNotAvailableException (reference: 20 s).
        snapshot_interval: rounds between host snapshots of the batched
            state used for failed-round recovery; 0 disables.

    ``run()`` returns rounds x B; ``final_state`` is batch-leading numpy;
    frame ids count rounds from the resume point.
    """

    def __init__(
        self,
        sources,
        pipeline,
        host_modules: Iterable[HostModule] = (),
        *,
        timing: TimingWriter | None = None,
        image_sink=None,
        max_frames: int | None = None,
        max_in_flight: int = 4,
        extra_fetch_keys: Iterable[str] = (),
        checkpoint_path: str | None = None,
        checkpoint_interval: int = 100,
        resume_from: str | None = None,
        data_timeout: float = 20.0,
        snapshot_interval: int = 64,
    ):
        sources = list(sources)
        if not sources:
            raise ValueError("the multi-sequence mode needs at least one source")
        super().__init__(
            sources[0], pipeline, host_modules, max_in_flight=max_in_flight, timing=timing,
            image_sink=image_sink, max_frames=max_frames, extra_fetch_keys=extra_fetch_keys,
            checkpoint_path=checkpoint_path, checkpoint_interval=checkpoint_interval,
            resume_from=resume_from, data_timeout=data_timeout,
            snapshot_interval=snapshot_interval, run_retention=0,
        )
        self.sources = sources
        self.batch = len(sources)
        self._warned_keys: set[str] = set()
        # (variant, fetch keys) -> the B sequences' step as one CUDA graph
        self.captured_steps: dict[tuple, CapturedStep] = {}
        self._buffers: StaticBuffers | None = None

    # ----------------------------------------------------- frames and steps

    def _sources(self) -> list:
        return self.sources

    def _read(self):
        """The next round's frames stacked [B, ...] (on a card into pinned
        host memory), or None once any source is exhausted."""
        frames = []
        for s in self.sources:
            if s.is_finished():
                return None
            f = s.get_next()
            if f is None:
                return None
            frames.append(to_grayscale(f) if self.pipeline.ctx.grayscale else f)
        pin = self.device.type == "cuda"
        images = {}
        for k, v in frames[0].items():
            if not isinstance(v, np.ndarray):
                continue
            buf = torch.empty((self.batch, *v.shape), dtype=torch.from_numpy(v[:0]).dtype,
                              pin_memory=pin)
            for b, f in enumerate(frames):
                buf[b].copy_(torch.from_numpy(np.ascontiguousarray(f[k])))
            images[k] = buf
        return {k: v.numpy() for k, v in images.items()}, images

    def _initial_state(self) -> dict:
        return stack_trees([self.pipeline.init_state()] * self.batch)

    def _static_buffers(self, frame_np):
        if self._buffers is None:
            self._buffers = StaticBuffers(self.pipeline, frame_np, batch=self.batch)
        return self._buffers

    def _captured_step(self, variant):
        key = (variant, self._fetch_keys)
        step = self.captured_steps.get(key)
        if step is None:
            step = self.captured_steps[key] = CapturedStep(self.pipeline, self._buffers,
                                                           variant, self._fetch_keys)
        return step

    def _eager_step(self, state, frame_dev, params, variant):
        return batched_step(self.pipeline, state, frame_dev, params, variant,
                            keys=self._fetch_keys)

    # -------------------------------------------------------- host callbacks

    def _module_fetched(self, m, fetched: dict) -> dict:
        # Each key as the module declares (Module.host_fetch_reduce): 'sum'
        # keys (histograms) summed over the batch, so the shared provider
        # sees the whole batch's statistics; an undeclared key falls back to
        # sequence 0 with a one-time warning (a blanket batch-sum would
        # silently corrupt non-additive outputs).
        reduce_spec = m.host_fetch_reduce()
        sub = {}
        for k in m.host_fetch_keys():
            if k not in fetched:
                continue
            v = fetched[k]
            how = reduce_spec.get(k)
            if how == "sum" and v.ndim >= 1:
                sub[k] = v.sum(axis=0)
                continue
            if how is None and k not in self._warned_keys:
                self._warned_keys.add(k)
                log.warning("multiseq: key '%s' of module %s declares no batch reduction; "
                            "using sequence 0 only", k, m.name)
            sub[k] = v[0] if v.ndim >= 1 else v
        return sub

    def _host_view(self, frame_np, fetched: dict):
        # Host modules process and render sequence 0, with no frame, as in
        # the JAX class.
        return {}, {k: v[0] for k, v in fetched.items()}


class SpatialMultiSeqSystem(MultiSeqSystem):
    """Sequences x spatial: B sequences, each height-sharded over the
    SpatialPipeline's row shards, on one card (config: ``{"parallel":
    {"mode": "spatial", "devices": n, "sequences": B}}``, n // B shards a
    sequence).  The MultiSeqSystem loop with the batched spatial step, the
    counterpart of ``jitted_batched_step``: on the card one CUDA graph a
    variant holds the B sequences' ``SpatialPipeline.compute_step``, each on
    its sequence's stream, where its shard threads enqueue; a CPU context
    runs each sequence's ``SpatialPipeline.step`` in turn.  The collectives
    stay within the sequence's shards, as the JAX step's name only the
    spatial axis.  The sequences share the pipeline's ShardGroup and so
    shard i's K5 side stream: their K5 output passes order one after the
    other in the graph (parallel/group.py says why)."""
