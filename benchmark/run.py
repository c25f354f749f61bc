"""The benchmark's command: one run of one cell on the card.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the result as the last line of
standard output (one JSON object) and the numbers compared, each beside its
limit, as the last lines of standard error.  Exits with another code than 0,
printing no result, where no card (or too few) is visible, where the
program is not in the checkout, or where JAX or the JAX package is loaded
once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# One intra-op CPU thread, set before torch is imported.  The System's
# frame path runs small CPU tensor copies (pinning, fetches); with
# PyTorch's default pool of one thread a core, the pool's spinning threads
# take the cores from the System's own threads, and a run's frame rate
# swings by a third from run to run.
os.environ["OMP_NUM_THREADS"] = "1"

ROOT = Path(__file__).resolve().parents[1]
# The checkout's root first, in place of this file's directory, so that the
# benchmark's modules are imported as a package and shadow nothing.
sys.path[0] = str(ROOT)


def limit_cards(chips: int) -> None:
    """The cell's cards only, set before torch is imported: the first `chips`
    of CUDA_VISIBLE_DEVICES where it lists more, indices 0..chips-1 where it
    is unset.  The program's multi-sequence mode splits its batch over every
    card it sees, so a one-card cell on a host with more would spread its
    rounds over them."""
    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    if listed is None:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(chips))
    else:
        cards = [c.strip() for c in listed.split(",") if c.strip()]
        if len(cards) > chips:
            os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(cards[:chips])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from benchmark import spec

    chips = spec.cell(spec.load(ROOT), args.workload)["chips"]
    limit_cards(chips)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no card: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import cartslam_tpu_torch
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    where = Path(cartslam_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"cartslam_tpu_torch comes from {where}, not from the checkout", file=sys.stderr)
        return 2

    def log(msg):
        print(f"[bench {time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr,
              flush=True)

    try:
        result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START, log)
    except harness.ForbiddenImport as e:
        print(str(e), file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
