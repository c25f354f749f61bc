"""A group of row shards: the counterpart of a 1-D mesh axis and of
``jax.lax.{axis_index, ppermute, psum, all_gather}``.

``ShardGroup(n, devices).run(fn)`` runs ``fn(i)`` for the n shards, each on
its own thread, and returns their results in shard order.  Inside ``fn``
the collectives below see the calling shard's index.  Each collective is a
barrier: every shard deposits its tensor, waits for all the others, then
reads its peers' tensors.  The port's ``compute_spatial`` methods call
collectives in the middle of a function, as the JAX ones do inside a
``shard_map``; with one thread per shard they stay the JAX code line by line.

Ordering on the card, shared stream (the default when every shard is on
one card): every shard thread enqueues on the caller's current stream.  A
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
run would then have to warm up on its own capture stream).

Ordering with a stream per shard (shards on distinct devices, or
``streams="per_shard"`` on one card): shard i enqueues on a stream of its
own on its device, forked from the caller's current stream when ``run``
starts and joined back into it when every shard has returned.  A
collective becomes an event join: the producer records an event on its
stream as it deposits, the consumer's stream waits on the events of the
shards it reads, and ``_take`` copies a tensor from another device with a
non-blocking copy.  PyTorch runs a copy between two cards on the source
card's current stream, after a two-way event join with the destination
card's current stream; so ``_take`` makes a copy stream of the reading
shard's own on the source card current for the copy (``_copy_stream``):
the copy waits only for the reader's stream, which waited on the
producer's event, and the reader's stream waits for the copy.  A tensor
read by another stream than its own is marked as used there
(``record_stream``), so the allocator does not hand its memory out again
before that stream has read it.  In a shard thread the caller's stream
stays current on the caller's device, so a shard's copy of its rows from
that device orders after the caller's work.  After ``run``, a result on a
shard's card is copied to the caller's card on the shard's own stream
(``shard_stream``; parallel/spatial_flagship.py), which made it.

Under CUDA graph capture (runtime/graphs.py) the caller's current stream is
the capture stream, so the shard threads enqueue into the capture; a side
stream, a shard's own stream and its copy streams join the capture through
the event waits of their fork or of the copy's join.  Every copy between
cards thus runs on a stream in the capture and becomes a node of the graph,
which spans the group's cards.  The streams must exist before the capture
begins (the capture's warm-up makes them): ``side_stream``, ``run`` and
``_take`` raise rather than make one under capture.

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

from .distributed import canonical_device


class CollectiveTimeout(RuntimeError):
    pass


class ShardGroup:
    def __init__(self, n: int, devices: Sequence, timeout: float = 600.0,
                 streams: str = "shared"):
        if n < 1:
            raise ValueError(f"a shard group needs at least one shard, got {n}")
        devices = [canonical_device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{n} shards need {n} devices, got {len(devices)}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"the shards' devices mix types: {devices}")
        if streams not in ("shared", "per_shard"):
            raise ValueError(f"streams must be 'shared' or 'per_shard', not {streams!r}")
        self.n = n
        self.devices = devices
        self.streams = streams
        # Shards on distinct cards cannot share a stream.
        self.per_shard = devices[0].type == "cuda" and (
            streams == "per_shard" or len(set(devices)) > 1)
        self._shard_streams: list[torch.cuda.Stream] = []
        self.timeout = timeout
        self._local = threading.local()
        self._barrier: threading.Barrier | None = None  # one per run
        self._baton = threading.Lock()
        self._slots: list[list[Any]] = [[None] * n, [None] * n]
        self._side: dict[int, torch.cuda.Stream] = {}
        self._copy: dict[tuple[int, torch.device], torch.cuda.Stream] = {}

    # ------------------------------------------------------------- running

    def run(self, fn: Callable[[int], Any]) -> list:
        """fn(i) on shard i's thread for every shard; results in shard order."""
        self._barrier = threading.Barrier(self.n, timeout=self.timeout)
        results: list[Any] = [None] * self.n
        errors: list[BaseException | None] = [None] * self.n
        dev = self.devices[0]
        cuda = dev.type == "cuda"
        # The caller's stream: on the shards' card, or with a stream per
        # shard on the caller's current device (where the merged results go).
        caller = (torch.cuda.current_stream(None if self.per_shard else dev) if cuda
                  else None)
        streams = [caller] * self.n
        if self.per_shard:
            streams = self._own_streams()
            for s in streams:
                s.wait_stream(caller)  # the fork
        intra_op = torch.get_num_threads()

        def body(i: int):
            self._local.index = i
            self._local.gen = 0
            with self._baton:
                try:
                    if cuda:
                        with torch.cuda.stream(caller), torch.cuda.stream(streams[i]):
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
        if self.per_shard:
            for s in streams:
                caller.wait_stream(s)  # the join
        if not cuda:
            torch.set_num_threads(intra_op)  # the setting is process-wide: restore it
        real = [e for e in errors if e is not None
                and not isinstance(e, threading.BrokenBarrierError)]
        if real:
            raise real[0]
        if any(e is not None for e in errors):
            raise CollectiveTimeout(
                f"a shard collective waited more than {self.timeout} s for its peers")
        return results

    def _own_streams(self) -> list[torch.cuda.Stream]:
        """The shards' own streams, made at the first run, never under CUDA
        graph capture (a stream made there would lie outside it)."""
        if not self._shard_streams:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the shards' streams would be made under CUDA graph "
                                   "capture; run the step once before capturing it")
            self._shard_streams = [torch.cuda.Stream(device=d) for d in self.devices]
        return self._shard_streams

    def shard_stream(self, i: int) -> torch.cuda.Stream:
        """Shard i's own stream (with a stream per shard), on which its last
        ``run`` enqueued its work."""
        return self._own_streams()[i]

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
            self._side[i] = self._new_stream(self.devices[i], "a side stream")
        return self._side[i]

    def _copy_stream(self, source: torch.device) -> torch.cuda.Stream:
        """The calling shard's stream on card `source`, on which its copies
        from that card run (see Ordering with a stream per shard), made at
        its first use and kept."""
        key = (self._local.index, source)
        if key not in self._copy:  # each shard thread reads and writes its own keys
            self._copy[key] = self._new_stream(source, f"a copy stream on {source}")
        return self._copy[key]

    def _new_stream(self, device: torch.device, what: str) -> torch.cuda.Stream:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"shard {self._local.index}: {what} would be made under CUDA "
                               "graph capture; run the step once before capturing it")
        return torch.cuda.Stream(device=device)

    def _exchange(self, x) -> list:
        """Deposit x, wait for every shard, return all shards' deposits.

        Two slot lists alternate: a shard can only deposit into a list again
        after the next collective's barrier, which every shard reaches only
        after reading this one.  With a stream per shard, an event recorded
        on the depositor's stream goes with x (``_take`` waits on it)."""
        i = self._local.index
        slots = self._slots[self._local.gen % 2]
        self._local.gen += 1
        event = None
        if self.per_shard:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.devices[i]))
        slots[i] = (x, event)
        self._baton.release()  # the next shard runs while this one waits
        try:
            self._barrier.wait()
        finally:
            self._baton.acquire()
        return list(slots)

    def _take(self, deposit, k: int | None = None) -> torch.Tensor | None:
        """The tensor of a peer's deposit (its item k), on the calling
        shard's device and ordered on its stream: the event join and, from
        another device, the copy."""
        x, event = deposit
        if k is not None:
            x = x[k]
        if x is None:
            return None
        dev = self.devices[self._local.index]
        if not self.per_shard:
            return x.to(dev)
        torch.cuda.current_stream(dev).wait_event(event)
        if x.device == dev:
            x.record_stream(torch.cuda.current_stream(dev))  # the stream that reads x
            return x
        copy = self._copy_stream(x.device)
        with torch.cuda.stream(copy):
            y = x.to(dev, non_blocking=True)
        x.record_stream(copy)
        return y

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
                out.append(self._take(got[src], k))
        return out

    def barrier(self) -> None:
        """Wait until every shard has reached this point."""
        self._exchange(None)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every shard's x, added in shard order (so every shard
        gets the same bits)."""
        got = self._exchange(x)
        total = self._take(got[0])
        for t in got[1:]:
            total = total + self._take(t)
        return total

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's x concatenated along axis 0, in shard order."""
        return torch.cat([self._take(t) for t in self._exchange(x)], dim=0)
