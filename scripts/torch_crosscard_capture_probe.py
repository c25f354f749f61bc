#!/usr/bin/env python3
"""Can one CUDA graph span several cards?  The probe behind the captured
cross-card spatial step (cartslam_tpu_torch/runtime/graphs.py).

    python3 scripts/torch_crosscard_capture_probe.py

Needs two or more CUDA cards (run it in a 4-card call); imports no JAX and
nothing of the port.  Prints the card's name and power limit, torch's and
CUDA's versions, the signatures of the allocator's pool-routing calls, and
one line per case, ``CASE <name> ok|FAILED <detail>``:

  * ``one_graph``: design (a).  A capture begun on a stream of card 0 forks
    a stream of each other card through an event, and each of those runs a
    kernel on a peer copy of card 0's input (its allocations routed into a
    graph pool of its own card with ``_cuda_beginAllocateToPool``) and
    copies its result back; a ring of peer copies between the other cards
    stands in for K5's carry chain.  Held over 10 replays on new inputs
    against the eager body, and the pools' segments listed by card;
  * ``threads``: the same body with each card's work enqueued by a thread
    of its own under ``capture_error_mode="thread_local"``, as the shard
    threads of ``ShardGroup.run`` enqueue.

Ends with ``PROBE {"one_graph": bool, "threads": bool}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading

import torch

REPLAYS = 10
N = 1 << 20


def _card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _signature(name: str) -> str:
    fn = getattr(torch._C, name, None)
    return "absent" if fn is None else (fn.__doc__ or "").strip().splitlines()[0]


def _body(x: torch.Tensor, cards: list, streams: dict, threaded: bool) -> torch.Tensor:
    """x on card 0 -> each other card c (the k-th): y = x * (k + 1) + 1
    there; then each card adds its ring neighbour's y, copied across, and
    sends the sum back to card 0, where the results are added.  Every card's
    work on its own stream, forked from and joined into the caller's stream
    on card 0; with `threaded`, each phase's work of each card on a thread
    of its own."""
    home = x.device
    caller = torch.cuda.current_stream(home)
    others = cards[1:]
    made: dict = {}
    got: dict = {}

    def deposit(k: int, c) -> None:
        s = streams[c]
        with torch.cuda.stream(caller), torch.cuda.stream(s):
            y = x.to(c, non_blocking=True) * float(k + 1) + 1.0
            ev = torch.cuda.Event()
            ev.record(s)
        made[c] = (y, ev)

    def ring(k: int, c) -> None:
        prev = others[k - 1]
        py, pev = made[prev]
        s = streams[c]
        # a peer copy runs on the source card's current stream
        with torch.cuda.stream(caller), torch.cuda.stream(streams[prev]), \
                torch.cuda.stream(s):
            s.wait_event(pev)
            r = py.to(c, non_blocking=True)
            got[c] = (made[c][0] + r).to(home, non_blocking=True)

    for c in others:
        streams[c].wait_stream(caller)  # the fork
    for phase in (deposit, ring):
        if threaded:
            ts = [threading.Thread(target=phase, args=(k, c)) for k, c in enumerate(others)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        else:
            for k, c in enumerate(others):
                phase(k, c)
    for c in others:
        caller.wait_stream(streams[c])  # the join
    total = torch.zeros_like(x)
    for c in others:
        total = total + got[c]
    return total


def _one_graph(cards: list, threaded: bool) -> tuple[bool, str]:
    home = cards[0]
    streams = {c: torch.cuda.Stream(device=c) for c in cards[1:]}
    x = torch.randn(N, device=home)
    # warm-up: the streams' first use, peer access, the kernels
    cap = torch.cuda.Stream(device=home)
    cap.wait_stream(torch.cuda.current_stream(home))
    with torch.cuda.stream(cap):
        _body(x, cards, streams, threaded)
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    begun = []
    try:
        for c in cards[1:]:
            torch._C._cuda_beginAllocateToPool(c.index, pool)
            begun.append(c)
        with torch.cuda.graph(graph, pool=pool, stream=cap, capture_error_mode="thread_local"):
            out = _body(x, cards, streams, threaded)
    except Exception as e:  # noqa: BLE001 - reported
        return False, f"capture: {type(e).__name__}: {e}"
    finally:
        for c in begun:
            torch._C._cuda_endAllocateToPool(c.index, pool)
    bad = 0
    for r in range(REPLAYS):
        x.copy_(torch.randn(N, device=home))
        graph.replay()
        with torch.cuda.stream(cap):
            want = _body(x, cards, streams, threaded)
        torch.cuda.synchronize()
        bad += int(not torch.equal(out, want))
    segs = {}
    for s in torch.cuda.memory_snapshot():
        if tuple(s.get("segment_pool_id", (0, 0))) == tuple(pool):
            segs[s["device"]] = segs.get(s["device"], 0) + s["total_size"]
    del graph
    for c in cards[1:]:
        torch._C._cuda_releasePool(c.index, pool)
    detail = f"{REPLAYS} replays, {bad} differ; pool bytes by card {segs}"
    return bad == 0, detail


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("needs two or more CUDA cards", file=sys.stderr)
        return 2
    print(_card_line(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}", flush=True)
    for name in ("_cuda_beginAllocateToPool", "_cuda_beginAllocateCurrentStreamToPool",
                 "_cuda_beginAllocateCurrentThreadToPool", "_cuda_endAllocateToPool",
                 "_cuda_releasePool"):
        print(f"SIG {name}: {_signature(name)}", flush=True)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    peer = {f"{i}->{j}": torch.cuda.can_device_access_peer(i, j)
            for i in range(len(cards)) for j in range(len(cards)) if i != j}
    print(f"PEER {peer}", flush=True)
    result = {}
    for name, fn in (("one_graph", lambda: _one_graph(cards, False)),
                     ("threads", lambda: _one_graph(cards, True))):
        ok, detail = fn()
        result[name] = ok
        print(f"CASE {name} {'ok' if ok else 'FAILED'} {detail}", flush=True)
    print("PROBE " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
