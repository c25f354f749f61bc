#!/usr/bin/env python3
"""The shipped one-card multi-device paths of cartslam_tpu_torch, timed, so
that two checkouts are compared in one call.

    python3 scripts/torch_shipped_paths_probe.py [--root DIR]

Prints one line, ``CMP <root> {"spatial": ms, "multiseq": ms}``, after the
card's name and power limit:
  * spatial: configs/kitti-planeseg-spatial.json (8 row shards on the card,
    the shared stream) through build_system, captured, host keys, 34
    synthetic frames preloaded at 376x1248; median ms a frame over frames
    3..34 between frame ends (CUDA events after each frame's fetch copies);
  * multiseq: configs/kitti-planeseg.json's modules (minus the
    visualizations) for 8 synthetic sequences (seeds 0-7) through the
    MultiSeqSystem, captured, host keys, 34 rounds; median ms a round the
    same way.
--root imports the port from another checkout (an older commit unpacked
with git archive into a directory that .gitignore lists); the configs are
this checkout's.  Run parent, change, change, parent in one call to compare.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

H, W, FRAMES, B = 376, 1248, 34, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timed(system) -> float:
    """Median ms between frame ends of a System's run, frames 3.."""
    ends = []
    stage = system._stage

    def staged(outputs):
        slot = stage(outputs)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        return slot
    system._stage = staged
    system.run()
    torch.cuda.synchronize()
    ms = [ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))]
    return float(np.median(ms[1:]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    root = os.path.abspath(ap.parse_args().root)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.sources import PreloadedSource, SyntheticDataSource

    if not build.__file__.startswith(root):
        raise RuntimeError(f"imported {build.__file__}, not {root}'s port")
    build.build()
    build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def sequence(seed):
        return PreloadedSource.wrap(SyntheticDataSource(
            image_size=(H, W), num_frames=FRAMES, seed=seed, max_disparity=80.0, baseline=20.0))

    def copy(src):
        return PreloadedSource(src.frames, intrinsics=src.get_camera_intrinsics())

    seqs = [sequence(s) for s in range(B)]
    out = {}
    with open(os.path.join(REPO, "configs", "kitti-planeseg-spatial.json")) as f:
        cfg = json.load(f)
    system = build_system(copy(seqs[0]), cfg["modules"], device="cuda", parallel=cfg["parallel"])
    if not system.captured:
        raise AssertionError("the spatial System is not captured")
    out["spatial"] = timed(system)
    del system
    with open(os.path.join(REPO, "configs", "kitti-planeseg.json")) as f:
        mods = [m for m in json.load(f)["modules"] if "visualization" not in m["type"]]
    srcs = [copy(q) for q in seqs]
    system = build_system(srcs[0], mods, device="cuda",
                          parallel={"mode": "multiseq", "batch": B, "sources": srcs})
    if not system.captured:
        raise AssertionError("the MultiSeqSystem is not captured")
    out["multiseq"] = timed(system)
    print("CMP", root, json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
