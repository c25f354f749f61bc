"""How ``correct`` is decided: what the timed path produced, held against the
plain reference that the configuration names.

A configuration's ``reference`` key names its reference module, a file
under the benchmark's paths (``benchmark/reference/chain.py`` for the
superpixel plane segmentation).  A reference module gives:

  outputs(modules)   the output keys the chain of `modules` produces (it
                     raises on a chain it cannot follow)
  chains(modules, streams, q, device, fdt)
                     its per-stream state over each stream's frame cycle,
                     seen by cameras of reprojection matrix q, with float
                     work in fdt (float32: the reference)
  replay(chains, n, max_in_flight, snapshot_interval, visit, keys)
                     rounds 1..n of the streams in lock-step, in the
                     System's drain order: visit(t, {key: output}) for each,
                     an output a tensor [B, ...] or a dict of them; returns
                     {"state": {path: tensor [B, ...]}, "global": value}:
                     the state tree after round n (may be empty) and the
                     host global it compares
  CHECKS             its table of checks (reference/checks.py: output key,
                     check name, what it counts, limit, the reason for a
                     limit that is not 0, how the harness holds the output)
  GLOBAL, global_diff(got, want)
                     the key of the System's global data it compares (None:
                     none) and the count of its fields that differ

The System's run hands over what it delivered (``Deliveries``: every
round's outputs, batch-leading: [B, ...] for the B streams of a round, [1,
...] for a single stream's frame), the rounds that failed, the state it left
(``final_state``, batch-leading) and its global.  Every key the run fetches
(the traffic's ``fetch`` and the outputs the reference marks ``always``) is
compared by the reference's checks of that key; a fetched key that the
reference does not produce or check raises ``Unchecked`` before the run,
and a delivered key that no check compares raises after it.  The numbers,
in this order:

  frames_missing   stereo frames dispatched whose outputs never came
  <the checks>     in the reference's order, each counting over every
                   stream of every delivered round (planes_px_diff,
                   hist_bins_diff, depth_diff for the plane segmentation)
  state_diff       elements of the final state that differ, every stream's
                   (0 where the reference keeps no state)
  params_diff      fields of the final host global that differ (0 where the
                   reference compares none)

frames_missing, state_diff and params_diff have the limit 0; a check has
its own.
"""

from __future__ import annotations

import ctypes
import importlib.util
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .reference.checks import Check

GENERIC = ("frames_missing", "state_diff", "params_diff")


class Unchecked(ValueError):
    """A fetched or delivered output that the reference does not check."""


def reference_of(root, config: dict):
    """The reference module the configuration names: the .py file
    root / config["reference"], the one spec.validate checks, loaded from
    that file.  It takes the dotted name of its path, so that its relative
    imports resolve in its package; a module of that name already loaded
    from another file is replaced."""
    path = (Path(root) / config["reference"]).resolve()
    name = config["reference"].removesuffix(".py").replace("/", ".")
    module = sys.modules.get(name)
    if module is None or Path(module.__file__).resolve() != path:
        found = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(found)
        sys.modules[name] = module
        found.loader.exec_module(module)
    return module


def checks_of(ref, modules: list, fetch: list) -> list[Check]:
    """The reference's checks that a run of `modules` fetching `fetch`
    compares, in the table's order: those of the fetched keys, and those
    marked ``always`` whose output the chain produces."""
    names = [c.name for c in ref.CHECKS]
    if len(set(names)) != len(names) or set(names) & set(GENERIC):
        raise ValueError(f"{ref.__name__}: check names repeat or shadow {GENERIC}: {names}")
    for c in ref.CHECKS:
        if c.kept not in ("every", "first") or c.limit < 0 or (c.limit and not c.why):
            raise ValueError(f"{ref.__name__}: check {c.name}: kept is 'every' or 'first', "
                             "a limit >= 0, and a limit above 0 has its reason")
    produced = ref.outputs(modules)
    for key in fetch:
        if key not in produced or not any(c.output == key for c in ref.CHECKS):
            raise Unchecked(f"the traffic fetches {key!r}, which {ref.__name__} does not "
                            f"produce and check for this chain (it checks {sorted(produced)})")
    return [c for c in ref.CHECKS if c.output in produced and (c.output in fetch or c.always)]


def leaves(tree, prefix: str = "") -> dict:
    """{path: array} of an output dict: "key" for an array, "key/leaf" for
    the leaves of a dict output."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


_libc = ctypes.CDLL(None)
_libc.memcmp.restype = ctypes.c_int
_libc.memcmp.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t)


def _same_bytes(a, b) -> bool:
    """Two host arrays of one dtype and shape whose bytes are equal: one
    memcmp, which holds no lock and allocates nothing."""
    if a is None or b is None or a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return _libc.memcmp(a.ctypes.data, b.ctypes.data, a.nbytes) == 0


def _bytes_differ(a, b) -> int:
    """Elements of two host arrays whose bytes differ; a leaf missing on one
    side, or a dtype or shape that differs, counts every element of the
    larger side."""
    if a is None or b is None or a.dtype != b.dtype or a.shape != b.shape:
        return max(x.size for x in (a, b) if x is not None)
    a, b = (np.ascontiguousarray(x).view(np.uint8).reshape(x.size, x.itemsize) for x in (a, b))
    return int(np.count_nonzero((a != b).any(axis=1)))


class Deliveries:
    """What a run delivered, held for the comparison.

    Outputs whose checks keep "every": each delivered round's leaves
    (``rounds``, round id -> {leaf: array}; a round with none of them is
    there too, empty, so that it counts as delivered).  Outputs kept
    "first": the first copy delivered at each position of the frame cycle,
    with the number of deliveries equal to it (``copies``, position ->
    [{leaf: array}, count]).  Every later delivery of a position is
    compared with that copy byte for byte and dropped; one that differs
    adds, leaf by leaf, its count of elements whose bytes differ from the
    copy's (``differing``): two different deliveries of one frame are at
    least one wrong one.  That comparison runs on a thread of its own, off
    the caller's path, behind a queue of at most one cycle of deliveries;
    the caller waits only where the queue is full (``waited``, round id ->
seconds).  So a
    run holds one copy a position and stream.  A round that lacks such an
    output is noted (``absent``) and counted as differing in every element
    of the reference's.
    """

    def __init__(self, checks: list[Check], cycle: int):
        self.cycle = cycle
        self.compared = {c.output for c in checks}
        self.first_keys = {c.output for c in checks if c.kept == "first"}
        self.rounds: dict[int, dict] = {}
        self.copies: dict[int, list] = {}
        self.differing: dict[str, int] = {}
        self.absent: dict[int, set] = {}
        self.unchecked: set[str] = set()
        self.waited: dict[int, float] = {}
        self.most_queued = 0
        self._error: BaseException | None = None
        self._queue = None
        if self.first_keys:
            self._queue = queue.Queue(maxsize=cycle)
            self._thread = threading.Thread(target=self._drain, name="bench-deliveries",
                                            daemon=True)
            self._thread.start()

    def position(self, t: int) -> int:
        return (t - 1) % self.cycle

    def put(self, t: int, outputs: dict) -> None:
        """Round t's outputs {key: array [B, ...] or dict of them}."""
        self.unchecked |= set(outputs) - self.compared
        flat = leaves(outputs)
        first = {k: v for k, v in flat.items() if k.split("/")[0] in self.first_keys}
        self.rounds[t] = {k: v for k, v in flat.items() if k not in first}
        if self.first_keys - set(outputs):
            self.absent[t] = self.first_keys - set(outputs)
        if not first:
            return
        t0 = time.perf_counter()
        self._queue.put((t, first))
        self.waited[t] = time.perf_counter() - t0
        self.most_queued = max(self.most_queued, self._queue.qsize())

    def _drain(self) -> None:
        while (item := self._queue.get()) is not None:
            try:
                self._hold(*item)
            except Exception as e:  # re-raised by close()
                self._error = e

    def _hold(self, t: int, first: dict) -> None:
        held = self.copies.get(self.position(t))
        if held is None:
            self.copies[self.position(t)] = [first, 1]
        elif all(_same_bytes(held[0].get(k), first.get(k)) for k in held[0].keys() | first.keys()):
            held[1] += 1
        else:
            for k in held[0].keys() | first.keys():
                self.differing[k] = (self.differing.get(k, 0)
                                     + _bytes_differ(held[0].get(k), first.get(k)))

    def close(self) -> None:
        """Wait until every delivery has been held or compared."""
        if self._queue is not None:
            self._queue.put(None)
            self._thread.join()
            self._queue = None
        if self._error is not None:
            raise self._error

    def held_bytes(self) -> int:
        return sum(a.nbytes for copy, _ in self.copies.values() for a in copy.values())


def _diff(c: Check, got: list, want: list, device) -> torch.Tensor:
    """Check c's count over rounds: got, want: one {leaf: ...} a round (the
    program's host arrays, the reference's tensors).  Each leaf that c
    covers is compared stacked; a leaf missing on one side, or a shape
    that differs, counts every element of the side that has it."""
    total = torch.zeros((), dtype=torch.int64, device=device)
    names = sorted({k for w in want for k in w if c.covers(k)}
                   | {k for g in got for k in g if c.covers(k)})
    for leaf in names:
        g = [x.get(leaf) for x in got]
        w = [x.get(leaf) for x in want]
        if all(a is not None and b is not None and a.shape == tuple(b.shape)
               for a, b in zip(g, w)):
            total += c.diff(torch.from_numpy(np.stack(g)).to(device), torch.stack(w))
        else:
            total += sum((b.numel() if b is not None else a.size) for a, b in zip(g, w))
    return total


def judge(ref, modules: list, streams: list, q, device, run: dict, checks: list[Check],
          max_in_flight: int, snapshot_interval: int, fdt=torch.float32) -> tuple[dict, dict]:
    """The numbers compared, each {"value", "limit"} in the order above,
    from `run` = {"deliveries": Deliveries, "failed": [round ids],
    "final_state": batch-leading host tree or None, "global": the program's
    host global or None}, over `streams` (each stream's frame cycle); and
    the reference's seconds by kind of work."""
    held: Deliveries = run["deliveries"]
    if held.unchecked:
        raise Unchecked(f"the program delivered {sorted(held.unchecked)}, which no check of "
                        f"{ref.__name__} compares")
    rounds = held.rounds
    n = max([*rounds, *run["failed"], 0])
    chains = ref.chains(modules, streams, q, device, fdt)
    every = [c for c in checks if c.kept == "every"]
    first = [c for c in checks if c.kept == "first"]
    sums = {c.name: torch.zeros((), dtype=torch.int64, device=device) for c in checks}
    pending: list = []
    compared_positions: set = set()

    def flush():
        """Compare the pending rounds in one batch: one upload of the
        program's outputs a leaf, no read back."""
        for c in every:
            sums[c.name] += _diff(c, [rounds[t] for t, _ in pending], [w for _, w in pending],
                                  device)
        pending.clear()

    def visit(t, outputs):
        want = leaves(outputs)
        if t in rounds and every:
            pending.append((t, {k: v for k, v in want.items()
                                if k.split("/")[0] not in held.first_keys}))
            if len(pending) * len(streams) >= 64:
                flush()
        for c in first:
            if c.output in held.absent.get(t, ()):
                sums[c.name] += sum(v.numel() for k, v in want.items() if c.covers(k))
        pos = held.position(t)
        if first and pos in held.copies and pos not in compared_positions:
            # The output depends on the frame alone: the copy held for the
            # position is compared once, for every delivery equal to it.
            compared_positions.add(pos)
            copy, count = held.copies[pos]
            for c in first:
                sums[c.name] += count * _diff(c, [copy], [want], device)

    t0 = time.perf_counter()
    expected = ref.replay(chains, n, max_in_flight, snapshot_interval, visit,
                          list(dict.fromkeys(c.output for c in checks)))
    if pending:
        flush()
    for c in first:
        sums[c.name] += sum(v for k, v in held.differing.items() if c.covers(k))
    state_diff = 0
    program_state = leaves(run["final_state"] or {})
    for path, want in expected["state"].items():
        want = want.cpu().numpy()
        got = program_state.get(path)
        if got is None or np.shape(got) != want.shape:
            state_diff += want.size
        else:
            state_diff += int(np.count_nonzero(np.asarray(got) != want))
    params_diff = ref.global_diff(run["global"], expected["global"]) if ref.GLOBAL else 0
    missing = sorted(set(range(1, n + 1)) - set(rounds))
    seconds: dict = {}
    for chain in chains:
        for k, v in getattr(chain, "seconds", {}).items():
            seconds[k] = seconds.get(k, 0.0) + v
    seconds["replay"] = time.perf_counter() - t0
    values = {"frames_missing": len(missing) * len(streams),
              **{c.name: int(sums[c.name]) for c in checks},
              "state_diff": int(state_diff), "params_diff": int(params_diff)}
    limits = {c.name: c.limit for c in checks}
    return {k: {"value": v, "limit": limits.get(k, 0)} for k, v in values.items()}, seconds


def as_program(ref, modules: list, streams: list, q, device, n: int, max_in_flight: int,
               snapshot_interval: int, checks: list[Check], cycle: int, fdt) -> dict:
    """The reference's own replay in `fdt`, in the form a System's run hands
    over (the control: the reference in the program's place)."""
    held = Deliveries(checks, cycle)

    def host(tree):
        """A copy on the host, as the System's fetch makes one: the
        reference may write its next round into the same tensor while the
        held output waits on the comparison thread."""
        return ({k: host(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.to("cpu", copy=True).numpy())

    try:
        out = ref.replay(ref.chains(modules, streams, q, device, fdt), n, max_in_flight,
                         snapshot_interval, lambda t, outputs: held.put(t, host(outputs)),
                         list(dict.fromkeys(c.output for c in checks)))
    finally:
        held.close()
    state: dict = {}
    for path, value in out["state"].items():
        node = state
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.cpu().numpy()
    return {"deliveries": held, "failed": [], "final_state": state, "global": out["global"]}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
