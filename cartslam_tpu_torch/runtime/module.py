"""Module contracts (counterpart of cartslam_tpu/runtime/module.py).

A module is a function over named tensors on the pipeline's device:
``compute(ctx, step, deps, state, params, variant) -> (outputs, new_state)``.
PyTorch runs eagerly, so ``compute`` executes directly; on the card the
System captures a whole step into one CUDA graph per variant
(runtime/graphs.py), the counterpart of tracing it into one program.  So
``compute`` reads nothing back to the host and copies nothing to the
device: the frame id is a device scalar and the host params are device
tensors, and a branch on either is a ``torch.where``.  Cross-frame
dependencies (``offset < 0``) are ring buffers in the explicit pipeline
state.  A ``HostModule`` consumes fetched numpy outputs on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Hashable, Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Dependency:
    """A required data key, optionally from a previous frame (offset <= 0)."""

    key: str
    offset: int = 0
    optional: bool = False


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a provided key (sizes the history rings)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def checked_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a GPU raises (the
    port never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


@dataclasses.dataclass(frozen=True)
class PipelineContext:
    """Static facts about the pipeline shared by all modules.  The device
    defaults to the card; CPU callers pass ``device="cpu"``."""

    height: int
    width: int
    q: np.ndarray  # 4x4 float32 disparity->3D reprojection matrix
    device: torch.device = torch.device("cuda")
    grayscale: bool = False

    def __post_init__(self):
        object.__setattr__(self, "device", checked_device(self.device))
        # Q on the device, made once: a step copies nothing from the host.
        object.__setattr__(self, "q_tensor", torch.as_tensor(
            np.asarray(self.q, np.float32)).to(self.device))

    @property
    def image_size(self) -> tuple[int, int]:
        return (self.height, self.width)


class StepContext:
    """Per-step access to frame inputs and history ring buffers."""

    def __init__(self, frame: Mapping[str, Any], history: Mapping[str, torch.Tensor]):
        self.frame = frame  # left, right, frame_id (+ source extras)
        self._history = history

    @property
    def frame_id(self) -> torch.Tensor:
        """1-based frame id, an int32 scalar on the device (reference run
        ids are 1-based)."""
        return self.frame["frame_id"]

    def history(self, key: str, offset: int) -> torch.Tensor:
        """Value of `key` from `offset` frames ago (offset <= -1)."""
        assert offset < 0
        return self._history[key][-offset - 1]

    def history_stack(self, key: str) -> torch.Tensor:
        """The [K, ...] ring of `key`: index k holds the value of frame t-1-k."""
        return self._history[key]

    def history_len(self, key: str) -> torch.Tensor:
        """The count of valid entries of `key`'s ring at this frame,
        min(frame_id - 1, K), an int32 scalar on the device (never read
        back, so a captured step can use it)."""
        return (self.frame_id - 1).clamp(max=self._history[key].shape[0])


class SpatialContext:
    """Row-sharded execution context for ``Module.compute_spatial``.

    The spatial mode (parallel/spatial_flagship.py) runs the same module
    list as the Pipeline on n row shards of ``h_local`` consecutive rows,
    one thread per shard (parallel/group.py).  Halo exchanges stand in for
    the reference's CUDA shared-memory tile aprons and ``psum`` for its
    global reductions.  One context serves every shard: the shard's index
    comes from the calling thread.
    """

    def __init__(self, group, h_local: int):
        self.group = group
        self.n = group.n
        self.h_local = h_local

    @property
    def index(self) -> int:
        return self.group.axis_index()

    @property
    def row0(self) -> int:
        """Global row index of this shard's first row."""
        return self.index * self.h_local

    def exchange(self, x: torch.Tensor, up: int, down: int, fill="edge") -> torch.Tensor:
        """Extend a row shard with `up`/`down` neighbour rows."""
        from ..parallel.halo import exchange_row_halo

        return exchange_row_halo(x, up, down, self.group, fill=fill)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.group.psum(x)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The full-height tensor (axis 0) on every shard."""
        return self.group.all_gather_rows(x)

    def slice_rows(self, full: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a full-height tensor (axis 0)."""
        return full[self.row0 : self.row0 + self.h_local]


class Module:
    """A compute module: function from named tensors to named tensors."""

    name: str = "module"

    def provides(self) -> list[str]:
        return []

    def requires(self) -> list[Dependency]:
        return []

    def output_spec(self, ctx: PipelineContext) -> dict[str, TensorSpec]:
        return {}

    def init_state(self, ctx: PipelineContext) -> dict[str, torch.Tensor]:
        """Persistent cross-frame state, on ctx.device."""
        return {}

    def initial_host_params(self, ctx: PipelineContext) -> dict[str, np.ndarray]:
        return {}

    def host_fetch_keys(self) -> list[str]:
        """Output keys this module wants back on host each frame."""
        return []

    def host_fetch_reduce(self) -> dict[str, str]:
        """Batch reduction per host-fetched key for the multi-sequence mode:
        'sum' marks an additive key (a histogram) that is summed over the
        sequences; an undeclared key is passed as sequence 0's, with a
        warning (parallel/system.py, MultiSeqSystem)."""
        return {}

    def host_update(
        self, ctx: PipelineContext, frame_id: int, fetched: Mapping[str, np.ndarray],
        system=None,
    ) -> dict[str, np.ndarray] | None:
        """Host-side per-frame hook; may return updated host params.
        `system` (when provided) allows global-data insertion, as
        System::insertGlobalData (include/cartslam.hpp:84)."""
        return None

    def variant(self, frame_id: int) -> Hashable:
        """Per-frame variant (e.g. superpixel reset): one captured graph
        each."""
        return None

    def host_state(self) -> dict:
        """Checkpointable host-side state (running histograms etc.)."""
        return {}

    def restore_host_state(self, state: dict) -> None:
        pass

    def compute(
        self,
        ctx: PipelineContext,
        step: StepContext,
        deps: Mapping[str, torch.Tensor],
        state: Mapping[str, torch.Tensor],
        params: Mapping[str, Any],
        variant: Hashable,
    ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """Returns (outputs keyed by provided names, new state)."""
        raise NotImplementedError

    # ------------------------------------------------------ spatial (sharded)

    def compute_spatial(self, ctx, step, deps, state, params, variant, sp: SpatialContext):
        """`compute` on a row shard in the spatial mode: every tensor (deps,
        state leaves, history, frame images, outputs) holds this shard's
        `sp.h_local` rows; halo rows come from `sp.exchange` and global
        reductions from `sp.psum`."""
        raise NotImplementedError(
            f"module {self.name} does not support the spatial latency "
            "mode (no compute_spatial); run it in single-chip or multiseq "
            "mode"
        )

    def supports_spatial(self) -> bool:
        return type(self).compute_spatial is not Module.compute_spatial

    def spatial_row_dims(self, ctx: PipelineContext) -> dict[str, int | None]:
        """Row-axis overrides for state leaves and output keys: the spatial
        composer splits each at the first dimension of extent ctx.height;
        None keeps a key whole (e.g. a psum'd histogram)."""
        return {}

    def spatial_validate(self, ctx: PipelineContext, n: int, h_local: int) -> None:
        """Raise if this module cannot run at `h_local` rows per shard."""


class HostModule:
    """A host-side consumer (visualization, recording) of fetched outputs.

    Mirrors the reference's VisualizationModule family
    (include/modules/visualization.hpp): runs off the device path, consumes
    numpy copies of selected keys, and produces BGR images for the viewer.
    """

    name: str = "hostmodule"
    _stream = None  # the module's own CUDA stream, made at its first device work

    def requires(self) -> list[Dependency]:
        return []

    def device_work(self, ctx: PipelineContext):
        """Context for device work done from ``process``: on a card it runs
        on a CUDA stream of the module's own, so a read back to the host
        waits for the module's work only, not for the frames in flight on
        the step's stream; on the CPU it does nothing."""
        if ctx.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=ctx.device)
        return torch.cuda.stream(self._stream)

    def provides_data(self) -> list[str]:
        """Per-run data keys this module computes on the host: the keys
        `process` returns are merged into the frame's fetched dict, so
        retained runs (System.get_run_by_id) and later host modules see
        them."""
        return []

    def process(self, ctx: PipelineContext, frame_id: int, frame: Mapping[str, np.ndarray],
                fetched: Mapping[str, np.ndarray],
                globals_: Mapping[str, Any]) -> dict[str, Any] | None:
        """Compute per-run host data (keys listed by provides_data)."""
        return None

    def render(self, ctx: PipelineContext, frame_id: int, frame: Mapping[str, np.ndarray],
               fetched: Mapping[str, np.ndarray],
               globals_: Mapping[str, Any]) -> np.ndarray | None | dict[str, np.ndarray]:
        """Return a BGR uint8 image (or a dict window name -> image)."""
        return None
