"""The control of the comparison: the reference itself, computed in bfloat16
where the configuration states float32 (the colour conversions, the flow
and the relaxation costs), put in the program's place.  The comparison
that decides ``correct`` has to reject it; its readings are the upper end
that each limit is set below.

    python benchmark/control.py --workload <name> --seeds 1,2,3 --frames <n>

Runs on the card (or with --device cpu); prints one JSON line a seed with
the numbers compared.  `frames` is as many as a run of the cell compares.
The benchmark's runs never run it.
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
from benchmark.data.synthetic import SyntheticScene  # noqa: E402
from benchmark.reference.chain import Chain  # noqa: E402


def control_readings(root: Path, workload: str, seed: int, frames: int, device: str,
                     fdt=torch.bfloat16) -> dict:
    """The numbers compared when the reference in `fdt` stands in for the
    program over frames 1..frames of the cell's stream."""
    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    config = spec.load_config(root, bench, cell["config"])
    traffic = spec.load_traffic(root, cell["traffic"])
    g = config["geometry"]
    scene = SyntheticScene((g["height"], g["width"]), seed, **traffic["scene"])
    cycle = scene.cycle(traffic["frame_cycle"], device=device)
    m, s = traffic["max_in_flight"], config["system"]["snapshot_interval"]
    low = compare.as_program(Chain(config["modules"], cycle, device, fdt), frames, m, s)
    checks, _ = compare.judge(config["modules"], cycle, torch.device(device), low, m, s)
    return checks


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
                          "control": "bfloat16", "checks": checks,
                          "correct": compare.correct(checks),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
