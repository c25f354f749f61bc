"""The pipeline step captured as a CUDA graph: the counterpart of
``Pipeline.jitted_step`` (cartslam_tpu/runtime/pipeline.py).

JAX traces a step into one compiled program per (variant, fetch keys) and
dispatches it with one call.  Here the eager step (``Pipeline.compute_step``)
is captured once per (variant, fetch keys) into a ``torch.cuda.CUDAGraph``
and replayed: its ~1100 kernel launches a flagship frame leave the host as
one replay.

A graph replays fixed addresses, so every input lives in a static buffer
(``StaticBuffers``), shared by all the variants' graphs of one pipeline:

  * the frame: ``left``, ``right`` (and any other array of the source's
    frames) and ``frame_id``, an int32 device scalar;
  * the whole state tree, history rings included;
  * the host params (e.g. the plane ranges), which the host step writes.

The captured region ends by copying the new state into the static state
buffers, so one replay advances the state IN PLACE.  That is where the port
departs from JAX's donated, functional state (``donate_argnums=(0,)``): no
new state tree exists after a replay, the buffers hold it.  The fetch keys'
outputs are static too: the next replay (of any variant) overwrites them,
so a caller copies them out (System enqueues the device-to-host copies
right after the replay, on the same stream).

The multi-sequence System (parallel/system.py) captures B sequences' steps
into one graph over batched buffers (``StaticBuffers(..., batch=B)``): the
frame images and every state leaf carry a leading [B] axis (the JAX
checkpoint layout), the frame id (the round) and the host params are shared.
Sequence b's step runs on a stream of its own, forked from the capture
stream and joined before each fetch key's B outputs are stacked, so the
branches may run side by side on the card; each writes its new state into
its own slice of the state buffers.  Every module object serves all B
branches, so what a module keeps between calls outside the state tree must be
read-only (a constant made once).

All graphs of a pipeline share one memory pool
(``torch.cuda.graph_pool_handle()``): one private pool each would hold the
flagship's ~500 MiB of step intermediates three times.  Sharing is safe here
because the graphs replay one at a time on one stream and no graph reads
another's pool memory: everything that crosses frames goes through the
static buffers, which lie outside the pool.

The launch counters (``kernels/build.COUNTERS``) count when a wrapper
enqueues a launch, which under capture is once.  A capture records each
counter's launches and puts the counters back as they were before its
warm-up, and every replay adds the recorded launches, so the counts of a
replayed run are those of the eager run.

The spatial step (parallel/spatial_flagship.SpatialPipeline.compute_step)
is captured the same way, the counterpart of its ``jitted_step`` and, over
batched buffers, of ``jitted_batched_step``.  Its work is enqueued by the
shard threads of ``ShardGroup.run``, not by the capturing thread: each shard
thread makes the caller's current stream its own, which is the capture
stream (or sequence b's stream) under capture, so its launches join the
capture, and K5's side streams join it through their fork's event wait.
Three things make that work:

  * the capture mode, ``"thread_local"``: a mode restricts the potentially
    unsafe CUDA calls (a synchronising copy, an event wait) of the threads
    it checks, not which threads may enqueue into a capturing stream.
    Thread-local mode checks only the thread that began the capture, so
    the shard threads' enqueues are captured as any other, while the
    System's prefetch and fetch threads keep using CUDA (pinned memory,
    event waits) during a capture.  What a shard thread does wrong on the
    capture stream (a read back) still fails the capture, since a
    capturing stream refuses it from any thread;
  * the allocator: PyTorch routes an allocation into the graph's pool by
    the stream it is made on (its filter compares the stream's capture id
    with the graph's), not by the thread, so the shard threads' tensors
    land in the pool like the capturing thread's;
  * the side streams: a side stream made during the capture would lie
    outside it until its fork, so they are made by the warm-up (one per
    shard, shared by the composed mode's sequences);
    ``ShardGroup.side_stream`` raises if one would be made under capture.

A shard's exception under capture re-raises in the capturing thread and
fails the capture (``CaptureError``); nothing runs the step eagerly instead.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Mapping

import numpy as np
import torch

from ..kernels import build
from .state import map_tree, stack_trees


class CaptureError(RuntimeError):
    """A step could not be captured into a CUDA graph (no eager fallback)."""


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _copy_into(dst, src) -> None:
    """Copy a tree of tensors (or arrays) into the static tree `dst` of the
    same keys, shapes and dtypes, on the current stream.  Host arrays go
    through pinned memory with a non-blocking copy."""
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"tree keys differ: {sorted(dst)} vs {sorted(src)}")
        for k in dst:
            _copy_into(dst[k], src[k])
        return
    non_blocking = False
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
        if dst.device.type == "cuda":
            src, non_blocking = src.pin_memory(), True
    if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
        raise ValueError(f"shape/dtype {tuple(src.shape)} {src.dtype}, expected "
                         f"{tuple(dst.shape)} {dst.dtype}")
    if src.data_ptr() != dst.data_ptr():
        dst.copy_(src, non_blocking=non_blocking)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class StaticBuffers:
    """The device buffers that every captured variant of one pipeline reads
    and writes.  `frame`: an example host frame (numpy arrays) for the
    images' shapes and dtypes.  The state and the host params start as the
    pipeline's initial ones.  With `batch`=B, the frame's images are
    already stacked [B, ...], every state leaf is B copies of the initial
    one, and each sequence has a stream of its own (``streams``).  On the
    CPU (no pool, no streams) the buffers serve the eager bodies alone."""

    def __init__(self, pipeline, frame: Mapping[str, Any], batch: int | None = None):
        dev = pipeline.ctx.device
        self.device = dev
        self.batch = batch
        self.frame: dict[str, torch.Tensor] = {
            k: torch.empty(v.shape, dtype=_torch_dtype(v.dtype), device=dev)
            for k, v in frame.items() if isinstance(v, np.ndarray)
        }
        self.frame["frame_id"] = torch.zeros((), dtype=torch.int32, device=dev)
        init = pipeline.init_state()
        self.state = (map_tree(torch.Tensor.clone, init) if batch is None
                      else stack_trees([init] * batch))
        self.params = pipeline.device_params(pipeline.init_host_params())
        cuda = dev.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.streams = [torch.cuda.Stream(device=dev) for _ in range(batch or 0)] if cuda else []
        # The captures' stream, on the buffers' card (PyTorch's default
        # capture stream lies on the card of the process's first capture).
        self.capture_stream = torch.cuda.Stream(device=dev) if cuda else None
        self._state_storages = {t.untyped_storage().data_ptr() for t in _leaves(self.state)}

    def sequence(self, b: int) -> tuple[dict, dict]:
        """(state, frame) of sequence b of batched buffers: views of slice b,
        the frame id shared."""
        frame = {k: v if k == "frame_id" else v[b] for k, v in self.frame.items()}
        return map_tree(lambda t: t[b], self.state), frame

    def load_frame(self, images: Mapping[str, torch.Tensor], frame_id: int) -> None:
        """Enqueue the next frame's copies on the current stream: `images`
        (pinned host tensors) with non-blocking copies, the id by a fill.
        Stream order puts them after the replays already enqueued."""
        for k, buf in self.frame.items():
            if k == "frame_id":
                buf.fill_(int(frame_id))
            else:
                buf.copy_(images[k], non_blocking=True)

    def load_state(self, tree) -> None:
        """Overwrite the static state with a tree of arrays or tensors."""
        _copy_into(self.state, tree)

    def load_params(self, host_params) -> None:
        """Overwrite the static host params with the host step's."""
        _copy_into(self.params, host_params)

    def aliases_state(self, t: torch.Tensor) -> bool:
        return t.untyped_storage().data_ptr() in self._state_storages


def counter_snapshot() -> dict[str, tuple[int, int]]:
    return {name: (c.launches, c.plain_calls) for name, c in build.COUNTERS.items()}


def _restore_counters(snap: dict[str, tuple[int, int]]) -> None:
    for name, c in build.COUNTERS.items():
        c.launches, c.plain_calls = snap.get(name, (0, 0))


@contextlib.contextmanager
def _no_gc():
    """One collection, then Python's cyclic collector off for the block.  A
    collection during a capture can free an unreachable CUDA graph of an
    earlier pipeline, and destroying a graph is not permitted while a stream
    captures: it invalidates the capture."""
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _sequence_body(pipeline, bufs: StaticBuffers, state, frame, variant,
                   fetch_keys: frozenset) -> dict[str, torch.Tensor]:
    """One sequence's step on its static `state` and `frame`: the new state
    written back into `state`, the fetch keys' outputs returned."""
    new_state, available = pipeline.compute_step(state, frame, bufs.params, variant)
    # The write-back below would change an output that shares memory with
    # the state.
    outputs = {k: v.clone() if bufs.aliases_state(v) else v
               for k, v in available.items() if k in fetch_keys}
    _copy_into(state, map_tree(lambda t: t.clone() if bufs.aliases_state(t) else t,
                                new_state))
    return outputs


def _batched_body(pipeline, bufs: StaticBuffers, variant,
                  fetch_keys: frozenset) -> dict[str, torch.Tensor]:
    """Sequence b's step on stream b of batched buffers, forked from the
    current stream and joined back into it: the new states written back,
    each fetch key's B outputs stacked after the join.  On the CPU the
    sequences run one after another."""
    main = torch.cuda.current_stream(bufs.device) if bufs.streams else None
    per_sequence = []
    for b in range(bufs.batch):
        stream = bufs.streams[b] if bufs.streams else None
        if stream is not None:
            stream.wait_stream(main)
        with torch.cuda.stream(stream):  # a no-op for None, on the CPU
            state, frame = bufs.sequence(b)
            per_sequence.append(_sequence_body(pipeline, bufs, state, frame, variant,
                                               fetch_keys))
    for stream in bufs.streams:
        main.wait_stream(stream)
    return {k: torch.stack([o[k] for o in per_sequence]) for k in per_sequence[0]}


def _batched_warm_up(pipeline, bufs: StaticBuffers, variant) -> None:
    """Each sequence's step once on its own stream, one after another, the
    results dropped.  A warm-up's blocks stay cached on its stream, which
    runs nothing but captures (in the graphs' pool) later, so they are
    released before the next sequence's: the peak holds one warm-up, not B."""
    main = torch.cuda.current_stream(bufs.device)
    for b, stream in enumerate(bufs.streams):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            state, frame = bufs.sequence(b)
            pipeline.compute_step(state, frame, bufs.params, variant)
        main.wait_stream(stream)
        torch.cuda.empty_cache()


class CapturedStep:
    """One (variant, fetch keys) of a pipeline's step as a CUDA graph over
    `buffers`.  Calling it replays the graph on the current stream and
    returns the fetch keys' outputs (static tensors, valid until the next
    replay of any variant).

    Built in three steps: one eager warm-up run of the step body on a side
    stream, or of each sequence's on its own stream (the kernels' first
    launches, the allocator's blocks, the shards' side streams; its results
    are dropped and the state is not written), the capture with the shared
    pool, and the counts of each kernel's launches at capture (B times a
    sequence's when batched).  ``capture_error_mode=
    "thread_local"``: only the capturing thread's calls are checked (see
    the module docstring for the shard threads)."""

    def __init__(self, pipeline, buffers: StaticBuffers, variant: tuple,
                 fetch_keys: frozenset[str]):
        if buffers.device.type != "cuda":
            raise CaptureError(f"a captured step needs a CUDA device, not {buffers.device}")
        self.variant = variant
        self.fetch_keys = frozenset(fetch_keys)
        bufs = buffers
        before = counter_snapshot()
        t0 = time.perf_counter()
        try:
            if bufs.batch is None:
                side = torch.cuda.Stream(device=bufs.device)
                side.wait_stream(torch.cuda.current_stream(bufs.device))
                with torch.cuda.stream(side):
                    pipeline.compute_step(bufs.state, bufs.frame, bufs.params, variant)
                torch.cuda.current_stream(bufs.device).wait_stream(side)
            else:
                _batched_warm_up(pipeline, bufs, variant)
            at_capture = counter_snapshot()
            self.graph = torch.cuda.CUDAGraph()
            with _no_gc(), torch.cuda.graph(self.graph, pool=bufs.pool,
                                            stream=bufs.capture_stream,
                                            capture_error_mode="thread_local"):
                if bufs.batch is None:
                    outputs = _sequence_body(pipeline, bufs, bufs.state, bufs.frame, variant,
                                             self.fetch_keys)
                else:
                    outputs = _batched_body(pipeline, bufs, variant, self.fetch_keys)
        except Exception as e:
            _restore_counters(before)
            raise CaptureError(f"capturing the step of variant {variant!r} failed: {e}") from e
        self.capture_s = time.perf_counter() - t0
        delta = {name: (n - at_capture.get(name, (0, 0))[0], p - at_capture.get(name, (0, 0))[1])
                 for name, (n, p) in counter_snapshot().items()}
        _restore_counters(before)
        plain = {name: p for name, (_, p) in delta.items() if p}
        if plain:
            raise CaptureError(f"a plain version ran under capture: {plain}")
        self.launches = {name: n for name, (n, _) in delta.items() if n}
        self.outputs = outputs

    def __call__(self) -> dict[str, torch.Tensor]:
        self.graph.replay()
        for name, n in self.launches.items():
            build.counter(name).launches += n
        return self.outputs
