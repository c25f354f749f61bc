"""MultiSeqSystem: B sequences in lock-step through one pipeline, on the
visible cards and, under ``"multihost"``, across processes (counterpart of
cartslam_tpu/parallel/system.py).

The multi-sequence throughput mode (config: ``{"parallel": {"mode":
"multiseq", "batch": B}}``): B independent sequences advance in lock-step,
one round a frame of each.  JAX vmaps the step over the batch and shards the
batch over a ``data`` mesh of every device, dropped to a divisor of B.  Here
the B sequences split into contiguous partitions, one per listed device
(default: every visible card of the pipeline's device type, dropped to a
divisor of B).  Each partition has its own pipeline built on its device
(modules make device constants at construction, e.g. the context's Q), and
on a card its own static buffers (``StaticBuffers(..., batch=B/k)``) and one
CUDA graph a variant holding its sequences' steps, each on a stream of its
own (runtime/graphs.py), replayed on its device's stream; a CPU context runs
the eager batched step (parallel/multiseq.batched_step) partition by
partition.  With one device, one partition holds the whole batch.

Under ``"multihost"`` (parallel/distributed.py) each process holds a
contiguous share of the global batch (``sources`` are its own), and the hot
path crosses no process.  Once a round, the keys the modules' host steps
read (the int32 derivative histograms) are gathered from every process in
sequence order, with the round's success flag: every process then applies
the same host params, and a round that failed on any process is recorded
failed on all of them, which recover from the same snapshot (a round that
fails at dispatch is recorded when it is drained, in order, for the same
reason).  Host modules run on global sequence 0, which is process 0's.  A
checkpoint is gathered and written by process 0 in the JAX batched layout;
a resume reads each process's share of it.

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

from ..runtime.checkpoint import load_checkpoint, save_checkpoint
from ..runtime.graphs import CapturedStep, StaticBuffers
from ..runtime.module import HostModule
from ..runtime.state import map_tree, stack_trees, state_from_reference, state_to_numpy
from ..runtime.system import System, _on
from ..runtime.timing import TimingWriter
from ..sources.base import to_grayscale
from .distributed import (DataLayout, all_gather, canonical_device, gather, global_data_layout,
                          local_devices)
from .multiseq import batched_step

log = logging.getLogger("cart.multiseq")


def _concat(trees: list):
    """Host trees of the same structure -> one tree of their leaves
    concatenated on the leading (batch) axis."""
    if isinstance(trees[0], dict):
        return {k: _concat([t[k] for t in trees]) for k in trees[0]}
    return np.concatenate(trees)


class _Partition:
    """Sequences [lo, hi) of this process's batch on one device: the
    pipeline built on it and, on a card, its static buffers."""

    def __init__(self, pipeline, lo: int, hi: int):
        self.pipeline = pipeline
        self.device = canonical_device(pipeline.ctx.device)
        self.lo, self.hi = lo, hi
        self.buffers: StaticBuffers | None = None

    def rows(self, x):
        return x[self.lo:self.hi]


class _Buffers:
    """The partitions' static buffers, loaded as one batch: each partition
    takes its rows, on its device's current stream."""

    def __init__(self, partitions: list[_Partition], frame_np):
        self.partitions = partitions
        for p in partitions:
            with _on(p.device):
                p.buffers = StaticBuffers(p.pipeline, {k: p.rows(v) for k, v in frame_np.items()},
                                          batch=p.hi - p.lo)

    @property
    def state(self) -> list:
        return [p.buffers.state for p in self.partitions]

    def load_state(self, tree) -> None:
        """A list of the partitions' states, or one host tree of the batch."""
        for k, p in enumerate(self.partitions):
            with _on(p.device):
                p.buffers.load_state(tree[k] if isinstance(tree, list) else map_tree(p.rows, tree))

    def load_params(self, host_params) -> None:
        for p in self.partitions:
            with _on(p.device):
                p.buffers.load_params(host_params)

    def load_frame(self, images, frame_id: int) -> None:
        for p in self.partitions:
            with _on(p.device):
                p.buffers.load_frame({k: p.rows(v) for k, v in images.items()}, frame_id)


class MultiSeqSystem(System):
    """Drives B sources through one pipeline in lock-step.

    Args (the JAX class's):
        sources: exactly B DataSources (this process's share under
            multihost); the run ends when any source is exhausted.
        pipeline: the shared Pipeline; its modules run the host steps.
        devices: the devices the batch is split over (default: every
            visible device of the pipeline's type, dropped to a divisor of
            B).
        data_timeout: seconds before a hung result fetch raises
            DataNotAvailableException (reference: 20 s).
        snapshot_interval: rounds between host snapshots of the batched
            state used for failed-round recovery; 0 disables.

    ``run()`` returns rounds x B; ``final_state`` is batch-leading numpy
    (this process's sequences); frame ids count rounds from the resume
    point.
    """

    def __init__(
        self,
        sources,
        pipeline,
        host_modules: Iterable[HostModule] = (),
        *,
        devices=None,
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
        layout = self._layout()
        self.process_count, self.process_index = layout.process_count, layout.process_index
        self.first = self.process_index * self.batch  # this process's first global sequence
        self._fail_in_order = self.process_count > 1
        if self.process_index:
            self.host_modules = []  # they run on global sequence 0, process 0's
        self._host_keys = {k for m in pipeline.modules for k in m.host_fetch_keys()}
        self.partitions = self._partition(
            [canonical_device(d) for d in devices] if devices is not None
            else layout.local_devices)
        self.captured = self.captured and all(getattr(p.pipeline, "capturable", True)
                                              for p in self.partitions)
        # (variant, fetch keys, partition) -> a partition's steps as one CUDA graph
        self.captured_steps: dict[tuple, CapturedStep] = {}
        self._buffers: _Buffers | None = None

    def _layout(self) -> DataLayout:
        return global_data_layout(self.device.type)

    def _partition(self, devices: list) -> list[_Partition]:
        """Contiguous partitions of the batch, one per device, the device
        list dropped to a divisor of B."""
        while self.batch % len(devices):
            devices = devices[:-1]
        size = self.batch // len(devices)
        home = canonical_device(self.pipeline.ctx.device)
        pipes = {home: self.pipeline}
        for d in devices:
            if d not in pipes:
                pipes[d] = self.pipeline.on_device(d)
        return [_Partition(pipes[d], k * size, (k + 1) * size) for k, d in enumerate(devices)]

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

    def _initial_state(self) -> list:
        return [stack_trees([p.pipeline.init_state()] * (p.hi - p.lo)) for p in self.partitions]

    def _device_state(self, tree) -> list:
        return [state_from_reference(map_tree(p.rows, tree), p.device) for p in self.partitions]

    def _host_state(self, state) -> dict:
        return _concat([state_to_numpy(s) for s in state])

    def _static_buffers(self, frame_np):
        if self._buffers is None:
            self._buffers = _Buffers(self.partitions, frame_np)
        return self._buffers

    def _captured_step(self, variant):
        """The round's replay: each partition's graph of `variant` on its
        device's current stream; each fetch key's output a list of the
        partitions' parts."""
        steps = []
        for k, p in enumerate(self.partitions):
            key = (variant, self._fetch_keys, k)
            if key not in self.captured_steps:
                with _on(p.device):
                    self.captured_steps[key] = CapturedStep(p.pipeline, p.buffers, variant,
                                                            self._fetch_keys)
            steps.append(self.captured_steps[key])

        def replay() -> dict:
            outs = []
            for p, step in zip(self.partitions, steps):
                with _on(p.device):
                    outs.append(step())
            return {k: [o[k] for o in outs] for k in outs[0]}
        return replay

    def _device_params(self, host_params) -> list:
        return [p.pipeline.device_params(host_params) for p in self.partitions]

    def _eager_frame(self, state, images, frame_id: int, params, variant):
        states, outs = [], []
        for p, s, prm in zip(self.partitions, state, params):
            with _on(p.device):
                frame = {k: p.rows(v).to(p.device, non_blocking=True) for k, v in images.items()}
                frame["frame_id"] = torch.full((), frame_id, dtype=torch.int32, device=p.device)
                s, o = batched_step(p.pipeline, s, frame, prm, variant, keys=self._fetch_keys)
            states.append(s)
            outs.append(o)
        return states, {k: [o[k] for o in outs] for k in outs[0]}

    # --------------------------------------------------- across processes

    def _load_checkpoint(self, example):
        """The checkpoint holds the global batch: this process's share."""
        example = map_tree(lambda a: np.concatenate([a] * self.process_count), example)
        raw, frame_id, host_state = load_checkpoint(self.resume_from, example)
        return map_tree(lambda a: a[self.first:self.first + self.batch], raw), frame_id, host_state

    def _save_checkpoint(self, state, frame_id: int) -> None:
        tree = self._host_state(state)
        if self.process_count > 1:
            trees = gather(tree)
            if self.process_index:
                return
            tree = _concat(trees)
        save_checkpoint(self.checkpoint_path, tree, frame_id,
                        {m.name: m.host_state() for m in self.pipeline.modules})

    def _agree(self, frame_id: int, fetched: dict | None) -> dict | None:
        """Across processes: the keys the modules' host steps read, every
        process's sequences in global order, or None when the round failed
        on any process."""
        if self.process_count == 1:
            return fetched
        mine = None if fetched is None else {k: v for k, v in fetched.items()
                                             if k in self._host_keys}
        got = all_gather((frame_id, mine))
        if any(fid != frame_id for fid, _ in got):
            raise RuntimeError(f"the processes left lock-step: rounds {[f for f, _ in got]}")
        if any(m is None for _, m in got):
            return None
        return {k: np.concatenate([m[k] for _, m in got]) for k in mine}

    # -------------------------------------------------------- host callbacks

    def _module_fetched(self, m, agreed: dict) -> dict:
        # Each key as the module declares (Module.host_fetch_reduce): 'sum'
        # keys (histograms) summed over the batch, so the shared provider
        # sees the whole batch's statistics; an undeclared key falls back to
        # sequence 0 with a one-time warning (a blanket batch-sum would
        # silently corrupt non-additive outputs).
        reduce_spec = m.host_fetch_reduce()
        sub = {}
        for k in m.host_fetch_keys():
            if k not in agreed:
                continue
            v = agreed[k]
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
    SpatialPipeline's row shards (config: ``{"parallel": {"mode":
    "spatial", "devices": n, "sequences": B}}``, n // B shards a sequence).
    The MultiSeqSystem loop with the batched spatial step, the counterpart
    of ``jitted_batched_step``: on a card one CUDA graph a variant holds a
    partition's ``SpatialPipeline.compute_step`` of each sequence, each on
    its sequence's stream, where its shard threads enqueue; a CPU context
    (or a partition across cards) runs each sequence's
    ``SpatialPipeline.step`` in turn.  The collectives stay within the
    sequence's shards, as the JAX step's name only the spatial axis.  The
    (sequences x shards) grid is placed on the listed devices (default:
    every visible one) in contiguous blocks, cell (b, i) on device
    floor((b n + i) k / (B n)) of k; consecutive sequences whose shards sit
    on the same devices form a partition.  A partition's sequences share
    its pipeline's ShardGroup and so shard i's K5 side stream: their K5
    output passes order one after the other in the graph (parallel/group.py
    says why).  The spatial mode ignores ``"multihost"``, as the JAX
    registry does: the grid is one process's."""

    def _layout(self) -> DataLayout:
        return DataLayout(1, 0, local_devices(self.device.type))

    def _partition(self, devices: list) -> list[_Partition]:
        n, b_total, k = self.pipeline.n, self.batch, len(devices)
        cells = [tuple((b * n + i) * k // (b_total * n) for i in range(n))
                 for b in range(b_total)]
        bounds = [b for b in range(b_total) if b == 0 or cells[b] != cells[b - 1]] + [b_total]
        home = canonical_device(self.pipeline.ctx.device)
        pipes = {(home, *self.pipeline.group.devices): self.pipeline}
        parts = []
        for lo, hi in zip(bounds, bounds[1:]):
            shard_devices = [devices[j] for j in cells[lo]]
            key = (shard_devices[0], *shard_devices)
            if key not in pipes:
                pipes[key] = self.pipeline.on_device(shard_devices[0], shard_devices)
            parts.append(_Partition(pipes[key], lo, hi))
        return parts
