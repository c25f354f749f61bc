"""How ``correct`` is decided: what the timed path produced, held against the
plain reference (benchmark/reference).

The System's run hands over every round it delivered (the fetched
``planes`` and derivative histograms of each round id, batch-leading: [B,
...] for the B streams of a round, [1, ...] for a single stream's frame),
the rounds that failed, the state it left (``final_state``, batch-leading)
and the host step's last plane parameters.  The reference replays rounds
1..n of the same B streams in lock-step, in the System's drain order
(reference/chain.py), and each number below counts a disagreement:

  frames_missing   stereo frames dispatched whose outputs never came
  planes_px_diff   pixels of the delivered frames' planes that differ, over
                   every stream of every delivered round
  hist_bins_diff   derivative-histogram bins of the delivered frames that
                   differ, over every stream of every delivered round
  state_diff       elements of the final state that differ, every stream's
                   (superpixel labels, the flow's previous gray frame, the
                   temporal vote's carried state, the unsmoothed-planes
                   history)
  params_diff      fields of the final plane parameters that differ (one
                   set, shared by the streams)

Every comparison is exact, so each limit is 0.  The planes pass through
every layer the cells name (K1's disparity, the derivative, the superpixel
labels of K2 and K3, the flow, the temporal vote and K4's tally, and the
ranges of the host step, which in a multi-stream cell come from the
histograms summed over the streams), the histograms check the disparity
and the derivative directly, and the state checks the labels and the flow's
input.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .reference import chain as reference

LIMITS = {"frames_missing": 0, "planes_px_diff": 0, "hist_bins_diff": 0, "state_diff": 0,
          "params_diff": 0}
PLANES, HIST = "planes", "disparity_derivative_histogram"
PARAM_FIELDS = ("horizontal_range", "vertical_range", "horizontal_center", "vertical_center")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _field(params, name: str) -> list | None:
    """A plane-parameter field as a list of ints (None where absent)."""
    value = getattr(params, name, None)
    return None if value is None else [int(x) for x in np.ravel(np.asarray(value))]


def judge(modules: list, streams: list, device, run: dict, max_in_flight: int,
          snapshot_interval: int, fdt=torch.float32) -> tuple[dict, dict]:
    """The numbers compared, from `run` = {"delivered": {round id: fetched,
    batch-leading}, "failed": [round ids], "final_state": batch-leading host
    tree or None, "params": the program's plane parameters or None}, over
    `streams` (each stream's frame cycle); and the reference's seconds by
    kind of work."""
    delivered = run["delivered"]
    n = max([*delivered, *run["failed"], 0])
    chains = reference.chains(modules, streams, device, fdt)
    diffs = {PLANES: torch.zeros((), dtype=torch.int64, device=device),
             HIST: torch.zeros((), dtype=torch.int64, device=device)}
    pending: list = []

    def flush():
        """Compare the pending rounds in one batch: one upload of the
        program's outputs a key, no read back."""
        for key, want in ((PLANES, [p for _, p, _ in pending]),
                          (HIST, [h for _, _, h in pending])):
            got = [np.asarray(delivered[t][key]) for t, _, _ in pending]
            if all(g.shape == tuple(w.shape) for g, w in zip(got, want)):
                diffs[key] += (torch.from_numpy(np.stack(got)).to(device)
                               != torch.stack(want)).sum()
            else:
                diffs[key] += sum(w.numel() for w in want)
        pending.clear()

    def visit(t, planes, hist):
        if t in delivered:
            pending.append((t, planes, hist))
            if len(pending) * len(streams) >= 64:
                flush()

    t0 = time.perf_counter()
    expected = reference.replay(chains, n, max_in_flight, snapshot_interval, visit)
    if pending:
        flush()
    state_diff = 0
    program_state = dict(_leaves(run["final_state"] or {}))
    for path, ref in expected["state"].items():
        ref = ref.cpu().numpy()
        got = program_state.get(path)
        if got is None or np.shape(got) != ref.shape:
            state_diff += ref.size
        else:
            state_diff += int(np.count_nonzero(np.asarray(got) != ref))
    params_diff = sum(_field(run["params"], f) != _field(expected["params"], f)
                      for f in PARAM_FIELDS)
    missing = sorted(set(range(1, n + 1)) - set(delivered))
    seconds = {k: sum(c.seconds[k] for c in chains) for k in chains[0].seconds}
    seconds["replay"] = time.perf_counter() - t0
    return {"frames_missing": len(missing) * len(streams), "planes_px_diff": int(diffs[PLANES]),
            "hist_bins_diff": int(diffs[HIST]), "state_diff": int(state_diff),
            "params_diff": int(params_diff)}, seconds


def as_program(modules: list, streams: list, device, n: int, max_in_flight: int,
               snapshot_interval: int, fdt) -> dict:
    """The reference's own replay in `fdt`, in the form a System's run hands
    over (the control: the reference in the program's place)."""
    delivered = {}

    def visit(t, planes, hist):
        delivered[t] = {PLANES: planes.cpu().numpy(), HIST: hist.cpu().numpy()}

    out = reference.replay(reference.chains(modules, streams, device, fdt), n, max_in_flight,
                           snapshot_interval, visit)
    state: dict = {}
    for path, value in out["state"].items():
        node = state
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.cpu().numpy()
    return {"delivered": delivered, "failed": [], "final_state": state, "params": out["params"]}


def correct(checks: dict) -> bool:
    return all(checks[k] <= LIMITS[k] for k in LIMITS)
