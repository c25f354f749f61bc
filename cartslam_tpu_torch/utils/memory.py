"""Device memory report (counterpart of cartslam_tpu/utils/memory.py; the
reference's reportMemoryUsage, src/utils/cuda.cu:23-33, logs free / total
GPU memory).

On a card: per device, the caching allocator's bytes in use and their peak
(``torch.cuda.memory_stats``), the bytes it reserves, and the device's free
and total memory (``torch.cuda.mem_get_info``).  Without one: one line for
the CPU, which reports no memory stats.
"""

from __future__ import annotations

import logging

import torch

log = logging.getLogger("cart.memory")


def memory_stats() -> list[dict]:
    """One dict per visible CUDA device (bytes_in_use, bytes_limit: the
    device's total memory, peak_bytes_in_use, bytes_reserved, bytes_free),
    or one for the CPU, with the device's name only."""
    if not torch.cuda.is_available():
        return [{"device": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        ms = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "bytes_limit": total,
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": ms.get("reserved_bytes.all.current", 0),
            "bytes_free": free,
        })
    return out


def report_memory_usage() -> None:
    """Log one line per device (the reference logs free / total MB)."""
    for s in memory_stats():
        limit = s.get("bytes_limit")
        if limit:
            log.info("%s: %.1f / %.1f MB in use (peak %.1f), reserved %.1f MB, free %.1f MB",
                     s["device"], s["bytes_in_use"] / 1e6, limit / 1e6,
                     s["peak_bytes_in_use"] / 1e6, s["bytes_reserved"] / 1e6,
                     s["bytes_free"] / 1e6)
        else:
            log.info("%s: backend reports no memory stats", s["device"])
