"""A group of row shards: the counterpart of a 1-D mesh axis and of
``jax.lax.{axis_index, ppermute, psum, all_gather}``.

``ShardGroup(n, devices).run(fn)`` runs ``fn(i)`` for the n shards, each on
its own thread, and returns their results in shard order.  Inside ``fn``
the collectives below see the calling shard's index.  Each collective is a
barrier: every shard deposits its tensor, waits for all the others, then
reads its peers' tensors.  The port's ``compute_spatial`` methods call
collectives in the middle of a function, as the JAX ones do inside a
``shard_map``; with one thread per shard they stay the JAX code line by line.

Ordering on the card: in this version every shard's device is the same
card, and every shard thread enqueues on the caller's current stream.  A
producer's kernels are enqueued before it deposits their output, and a
consumer's kernels after it has passed the barrier, so stream order alone
orders them: no event or synchronisation is needed, and a deposited tensor
is handed over without a copy.  A shard may fork work onto a stream of its
own (``side_stream``; K5's output pass, kernels/sgm.sgm_fused_sharded): the
side stream waits on an event of the caller's stream for its inputs, and
the caller's stream waits on the side stream's end before the forking
function returns.  So every fork is joined inside the shard's call, and
what the shard deposits or returns is ordered on the caller's stream as
before.  A join orders everything enqueued after it on the shared stream,
so a fork that must not wait for the other shards' forked work is made
before a collective that every shard passes before it joins (the barrier
that ends parallel/sgm_sharded.settled_carries).  A shard's side stream
serves every caller stream: the sequences of the composed mode, each on a
stream of its own in a captured round, fork onto the same side streams, so
one sequence's forked work orders after the other's (a side stream per
shard and caller stream would let them overlap, but every capture of a
run would then have to warm up on its own capture stream).  A
device per shard is part of the interface so that a transport across
cards can slot in (``_to``).

Under CUDA graph capture (runtime/graphs.py) the caller's current stream is
the capture stream, so the shard threads enqueue into the capture; a side
stream joins the capture through the fork's event wait.  A side stream must
exist before the capture begins (the capture's warm-up makes it):
``side_stream`` raises rather than make one under capture.

Turns on the host: one shard runs Python at a time.  A shard holds the
group's baton from its start to its next collective, where it hands the
baton on while it waits.  Python runs one thread at a time anyway; with
eight threads contending for the interpreter at every tensor op, the
shards' host work took several times its serial time (measured on the
card).  The card still overlaps: it runs one shard's kernels while the
next shard enqueues its own.  On the CPU each shard thread runs its ops on
one intra-op thread: with a pool per shard thread, a 4-shard 48x64 run of
5 frames took 28.8 s instead of 4.4 on a loaded 8-core host.

Failure: an exception in any shard aborts the barrier, the other shards
leave their collectives at once, and ``run`` re-raises the first
exception in the caller.  A barrier that waits longer than ``timeout``
seconds (a shard that never reaches a collective) breaks too, and ``run``
raises; it never hangs.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import torch


class CollectiveTimeout(RuntimeError):
    pass


class ShardGroup:
    def __init__(self, n: int, devices: Sequence, timeout: float = 600.0):
        if n < 1:
            raise ValueError(f"a shard group needs at least one shard, got {n}")
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{n} shards need {n} devices, got {len(devices)}")
        if len(set(devices)) != 1:
            raise ValueError("every shard runs on one device in this version")
        self.n = n
        self.devices = devices
        self.timeout = timeout
        self._local = threading.local()
        self._barrier: threading.Barrier | None = None  # one per run
        self._baton = threading.Lock()
        self._slots: list[list[Any]] = [[None] * n, [None] * n]
        self._side: dict[int, torch.cuda.Stream] = {}

    # ------------------------------------------------------------- running

    def run(self, fn: Callable[[int], Any]) -> list:
        """fn(i) on shard i's thread for every shard; results in shard order."""
        self._barrier = threading.Barrier(self.n, timeout=self.timeout)
        results: list[Any] = [None] * self.n
        errors: list[BaseException | None] = [None] * self.n
        dev = self.devices[0]
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        intra_op = torch.get_num_threads()

        def body(i: int):
            self._local.index = i
            self._local.gen = 0
            with self._baton:
                try:
                    if stream is not None:
                        with torch.cuda.device(dev), torch.cuda.stream(stream):
                            results[i] = fn(i)
                    else:
                        # Each new thread would start its own intra-op pool,
                        # whose idle workers spin while the other shards run.
                        torch.set_num_threads(1)
                        results[i] = fn(i)
                except BaseException as e:  # noqa: BLE001 - re-raised in the caller
                    errors[i] = e
                    self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,), name=f"shard-{i}", daemon=True)
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if stream is None:
            torch.set_num_threads(intra_op)  # the setting is process-wide: restore it
        real = [e for e in errors if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real:
            raise real[0]
        if any(e is not None for e in errors):
            raise CollectiveTimeout(
                f"a shard collective waited more than {self.timeout} s for its peers")
        return results

    # --------------------------------------------------------- collectives

    def axis_index(self) -> int:
        """The calling shard's index."""
        return self._local.index

    def side_stream(self) -> torch.cuda.Stream | None:
        """A CUDA stream of the calling shard's own, for work it forks off
        the caller's stream (see Ordering on the card), made at its first
        use and kept; None on a CPU device.  Raises if it would be made
        while the caller's stream captures."""
        i = self._local.index
        if self.devices[i].type != "cuda":
            return None
        if i not in self._side:  # each shard thread reads and writes its own key
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"shard {i}: a side stream would be made under CUDA graph "
                                   "capture; run the step once before capturing it")
            self._side[i] = torch.cuda.Stream(device=self.devices[i])
        return self._side[i]

    def _exchange(self, x) -> list:
        """Deposit x, wait for every shard, return all shards' deposits.

        Two slot lists alternate: a shard can only deposit into a list again
        after the next collective's barrier, which every shard reaches only
        after reading this one."""
        i = self._local.index
        slots = self._slots[self._local.gen % 2]
        self._local.gen += 1
        slots[i] = x
        self._baton.release()  # the next shard runs while this one waits
        try:
            self._barrier.wait()
        finally:
            self._baton.acquire()
        return list(slots)

    def _to(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.devices[self._local.index])

    def ppermute(self, x: torch.Tensor | None,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor | None:
        """Shard dst receives shard src's x for each (src, dst) in perm; a
        shard that is no destination gets zeros, as in JAX.  x may be None:
        the shard hands on nothing, and its destination gets None, never
        zeros that it could take for data (None too for a shard that is no
        destination and passed None)."""
        return self.ppermutes((x, perm))[0]

    def ppermutes(self, *pairs: tuple[torch.Tensor | None, Sequence[tuple[int, int]]]) -> list:
        """Several ppermutes, (x, perm) each, in one collective: one
        barrier for all of them.  Returns what each ppermute returns."""
        got = self._exchange(tuple(x for x, _ in pairs))
        i = self._local.index
        out = []
        for k, (x, perm) in enumerate(pairs):
            src = next((s for s, d in perm if d == i), None)
            if src is None:
                out.append(None if x is None else torch.zeros_like(x))
            else:
                out.append(None if got[src][k] is None else self._to(got[src][k]))
        return out

    def barrier(self) -> None:
        """Wait until every shard has reached this point."""
        self._exchange(None)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every shard's x, added in shard order (so every shard
        gets the same bits)."""
        got = self._exchange(x)
        total = self._to(got[0])
        for t in got[1:]:
            total = total + self._to(t)
        return total

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's x concatenated along axis 0, in shard order."""
        return torch.cat([self._to(t) for t in self._exchange(x)], dim=0)
