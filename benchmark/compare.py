"""How ``correct`` is decided: what the timed path produced, held against the
plain reference (benchmark/reference).

The System's run hands over every frame it delivered (the fetched
``planes`` and derivative histogram of each frame id), the frames that
failed, the state it left (``final_state``) and the host step's last plane
parameters.  The reference replays frames 1..n of the same stream in the
System's drain order and each number below counts a disagreement:

  frames_missing   frames dispatched whose outputs never came
  planes_px_diff   pixels of the delivered frames' planes that differ
  hist_bins_diff   derivative-histogram bins of the delivered frames that differ
  state_diff       elements of the final state that differ (superpixel
                   labels, the flow's previous gray frame, the temporal
                   vote's carried state, the unsmoothed-planes history)
  params_diff      fields of the final plane parameters that differ

Every comparison is exact, so each limit is 0.  The planes pass through
every layer the cells name (K1's disparity, the derivative, the superpixel
labels of K2 and K3, the flow, the temporal vote and K4's tally, and the
ranges of the host step), the histograms check the disparity and the
derivative directly, and the state checks the labels and the flow's input.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.chain import Chain

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


def judge(modules: list, frames: list, device, run: dict, max_in_flight: int,
          snapshot_interval: int, fdt=torch.float32) -> tuple[dict, Chain]:
    """The numbers compared, from `run` = {"delivered": {frame id: fetched},
    "failed": [frame ids], "final_state": host tree or None, "params":
    the program's plane parameters or None}; and the reference chain (its
    seconds)."""
    delivered = run["delivered"]
    n = max([*delivered, *run["failed"], 0])
    chain = Chain(modules, frames, device, fdt)
    diffs = {PLANES: torch.zeros((), dtype=torch.int64, device=device),
             HIST: torch.zeros((), dtype=torch.int64, device=device)}
    pending: list = []

    def flush():
        """Compare the pending frames in one batch: one upload of the
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
            if len(pending) >= 64:
                flush()

    expected = chain.replay(n, max_in_flight, snapshot_interval, visit)
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
    return {"frames_missing": len(missing), "planes_px_diff": int(diffs[PLANES]),
            "hist_bins_diff": int(diffs[HIST]), "state_diff": int(state_diff),
            "params_diff": int(params_diff)}, chain


def as_program(chain: Chain, n: int, max_in_flight: int, snapshot_interval: int) -> dict:
    """The chain's own replay in the form a System's run hands over (the
    control: the reference in the program's place)."""
    delivered = {}

    def visit(t, planes, hist):
        delivered[t] = {PLANES: planes.cpu().numpy(), HIST: hist.cpu().numpy()}

    out = chain.replay(n, max_in_flight, snapshot_interval, visit)
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
