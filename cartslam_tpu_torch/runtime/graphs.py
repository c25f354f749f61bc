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
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import numpy as np
import torch

from ..kernels import build


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


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class StaticBuffers:
    """The device buffers that every captured variant of one pipeline reads
    and writes.  `frame`: an example host frame (numpy arrays) for the
    images' shapes and dtypes.  The state and the host params start as the
    pipeline's initial ones."""

    def __init__(self, pipeline, frame: Mapping[str, Any]):
        dev = pipeline.ctx.device
        if dev.type != "cuda":
            raise CaptureError(f"a captured step needs a CUDA device, not {dev}")
        self.device = dev
        self.frame: dict[str, torch.Tensor] = {
            k: torch.empty(v.shape, dtype=_torch_dtype(v.dtype), device=dev)
            for k, v in frame.items() if isinstance(v, np.ndarray)
        }
        self.frame["frame_id"] = torch.zeros((), dtype=torch.int32, device=dev)
        self.state = _map_tree(torch.Tensor.clone, pipeline.init_state())
        self.params = pipeline.device_params(pipeline.init_host_params())
        self.pool = torch.cuda.graph_pool_handle()
        self._state_storages = {t.untyped_storage().data_ptr() for t in _leaves(self.state)}

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


class CapturedStep:
    """One (variant, fetch keys) of a pipeline's step as a CUDA graph over
    `buffers`.  Calling it replays the graph on the current stream and
    returns the fetch keys' outputs (static tensors, valid until the next
    replay of any variant).

    Built in three steps: one eager warm-up run of the step body on a side
    stream (the kernels' first launches, the allocator's blocks; its
    results are dropped and the state is not written), the capture with the
    shared pool, and the counts of each kernel's launches at capture.
    ``capture_error_mode="thread_local"``: the System's prefetch and fetch
    threads keep using CUDA (pinned memory, event waits) while the main
    thread captures, and only the capturing thread's calls are checked."""

    def __init__(self, pipeline, buffers: StaticBuffers, variant: tuple,
                 fetch_keys: frozenset[str]):
        self.variant = variant
        self.fetch_keys = frozenset(fetch_keys)
        bufs = buffers
        before = counter_snapshot()
        t0 = time.perf_counter()
        try:
            side = torch.cuda.Stream(device=bufs.device)
            side.wait_stream(torch.cuda.current_stream(bufs.device))
            with torch.cuda.stream(side):
                pipeline.compute_step(bufs.state, bufs.frame, bufs.params, variant)
            torch.cuda.current_stream(bufs.device).wait_stream(side)
            at_capture = counter_snapshot()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=bufs.pool,
                                  capture_error_mode="thread_local"):
                new_state, available = pipeline.compute_step(bufs.state, bufs.frame,
                                                             bufs.params, variant)
                outputs = {}
                for k, v in available.items():
                    if k in self.fetch_keys:
                        # The write-back below would change an output that
                        # shares memory with the state.
                        outputs[k] = v.clone() if bufs.aliases_state(v) else v
                _copy_into(bufs.state, _map_tree(
                    lambda t: t.clone() if bufs.aliases_state(t) else t, new_state))
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
