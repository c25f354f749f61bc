"""Multi-host initialization (counterpart of cartslam_tpu/parallel/
distributed.py) over ``torch.distributed``.

Multi-host serves the multi-sequence throughput mode: each process holds a
contiguous share of the B sequences on its own cards, and the hot path
crosses no process.  What crosses processes is host data only: once a
round, the 'sum' keys the host step reads (the int32 derivative
histograms) and the round's success flag, so that every process applies
the same host params and recovers from the same failed rounds; and the
checkpoint gather.  So the process group is ``gloo`` over TCP, and no CUDA
tensor crosses it: several processes may share one card.

Config: ``{"parallel": {"multihost": {"coordinator": "10.0.0.1:1234",
"num_processes": 4, "process_id": 0}}}``, the JAX package's keys, or the
same environment names (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID), so one config file serves both packages.  The port also
reads ``timeout`` (seconds, default 300, JAX's initialization timeout): an
unreachable coordinator or a missing peer raises within it at start-up, and
a collective whose peer died raises within it later.  Nothing falls back to
a single-process run.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

log = logging.getLogger("cart.distributed")

DEFAULT_TIMEOUT_S = 300.0


def initialize_multihost(cfg: dict | None = None) -> bool:
    """Join the process group from config or environment; returns True when
    a multi-process run was initialized (False for the single-host case).
    Idempotent: a call after a successful initialization returns True."""
    cfg = dict(cfg or {})
    coordinator = cfg.get("coordinator", os.environ.get("JAX_COORDINATOR_ADDRESS"))
    num_processes = cfg.get("num_processes", os.environ.get("JAX_NUM_PROCESSES"))
    process_id = cfg.get("process_id", os.environ.get("JAX_PROCESS_ID"))
    if coordinator is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("multihost needs coordinator, num_processes and process_id "
                         f"(got {coordinator!r}, {num_processes!r}, {process_id!r})")
    timeout = float(cfg.get("timeout", DEFAULT_TIMEOUT_S))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout))
    layout = global_data_layout()
    log.info("multi-host runtime up: process %d/%d, %d local devices", layout.process_index,
             layout.process_count, len(layout.local_devices))
    return True


class DataLayout(NamedTuple):
    """The global sequence layout (the counterpart of ``global_data_mesh``):
    the processes, this one's index, and the devices it places its
    sequences on.  Process p holds a contiguous share of the global batch."""

    process_count: int
    process_index: int
    local_devices: list[torch.device]

    def share(self, batch: int) -> range:
        """The global sequences this process holds."""
        if batch % self.process_count:
            raise ValueError(f"a batch of {batch} sequences does not split over "
                             f"{self.process_count} processes")
        n = batch // self.process_count
        return range(self.process_index * n, (self.process_index + 1) * n)


def local_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every visible device of `device_type`: the cards, or the CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def canonical_device(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def global_data_layout(device_type: str = "cuda") -> DataLayout:
    if dist.is_initialized():
        return DataLayout(dist.get_world_size(), dist.get_rank(), local_devices(device_type))
    return DataLayout(1, 0, local_devices(device_type))


def global_device_count(device_type: str = "cuda") -> int:
    """The visible devices of `device_type` summed over the processes (the
    counterpart of ``len(jax.devices())``)."""
    n = len(local_devices(device_type))
    return sum(all_gather(n)) if dist.is_initialized() else n


def all_gather(obj: Any) -> list:
    """Every process's `obj` (picklable host data), in process order."""
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def gather(obj: Any) -> list | None:
    """Every process's `obj`, in process order, on process 0 (None on the
    others)."""
    first = dist.get_rank() == 0
    out: list | None = [None] * dist.get_world_size() if first else None
    dist.gather_object(obj, out, dst=0)
    return out
