"""The control of the comparison: the reference module that the cell's
configuration names, computed in bfloat16 where the configuration states
float32 (for the plane segmentation: the colour conversions, the flow, the
relaxation costs and the reprojection to depth), put in the program's
place.  The comparison
that decides ``correct`` has to reject it; its readings are the upper end
that each limit is set below.

    python benchmark/control.py --workload <name> --seeds 1,2,3 --frames <n>

Runs on the card (or with --device cpu); prints one JSON line a seed with
the numbers compared.  `frames` is as many rounds as a run of the cell
compares (a round is one frame of each of the mix's streams).  The
benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from benchmark import compare, spec  # noqa: E402
from benchmark.harness import render_streams  # noqa: E402


def control_readings(root: Path, workload: str, seed: int, frames: int, device: str,
                     fdt=torch.bfloat16) -> dict:
    """The numbers compared when the reference in `fdt` stands in for the
    program over rounds 1..frames of the cell's streams."""
    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    config = spec.load_config(root, bench, cell["config"])
    traffic = spec.load_traffic(root, cell["traffic"])
    ref = compare.reference_of(root, config)
    checks = compare.checks_of(ref, config["modules"], traffic["fetch"])
    streams, q = render_streams(config, traffic, seed, device)
    m, s = traffic["max_in_flight"], config["system"]["snapshot_interval"]
    low = compare.as_program(ref, config["modules"], streams, q, device, frames, m, s, checks,
                             traffic["frame_cycle"], fdt)
    compared, _ = compare.judge(ref, config["modules"], streams, q, torch.device(device), low,
                                checks, m, s)
    return compared


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[1]
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control_readings(root, args.workload, seed, args.frames, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "frames": args.frames,
                          "control": "bfloat16",
                          "checks": {k: c["value"] for k, c in checks.items()},
                          "correct": compare.correct(checks),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
