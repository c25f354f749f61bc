"""CLI: ``python -m cartslam_tpu_torch <config> [--device cuda] [--max-frames N]``.

Builds the pipeline from the same JSON configs as ``python -m cartslam_tpu``
and streams the source's frames through it on the chosen device.  There is
no fallback: ``--device cuda`` without a CUDA device raises.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cartslam_tpu_torch", description="CART-SLAM pipeline on PyTorch + CUDA"
    )
    parser.add_argument("config", nargs="+", help="config JSON (1 combined or 2 files)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("cart")

    from .config import read_config
    from .runtime import run

    pipeline, source = read_config(*args.config, device=args.device)
    t0 = time.perf_counter()
    result = run(pipeline, source, max_frames=args.max_frames)
    if pipeline.ctx.device.type == "cuda":
        torch.cuda.synchronize(pipeline.ctx.device)
    wall = time.perf_counter() - t0
    log.info("processed %d frames on %s in %.3f s", result.frames, pipeline.ctx.device, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
