#!/usr/bin/env python3
"""K5 (the height-sharded SGM of cartslam_tpu_torch) on one GPU, timed three
ways, and the ways of ordering its shards that were measured against the
one the port keeps.

    python3 scripts/torch_k5_probe.py [--root DIR] [--variants] [--timeline]

Runs K5 on 8 row shards of 47 rows of a synthetic 376x1248 frame, D = 256,
the shards as threads of one ShardGroup on this card, and prints, each
beside the card's name and power limit:
  * replay: a CUDA graph of one group.run of the 8 shards, replayed: ms a
    replay (CUDA events), and span, busy time (the union of K5's kernel
    intervals) and time by kernel from torch.profiler.  The host is not in
    these numbers;
  * run: the same from group.run as the shard threads make it (the host
    paces these), and the host-inclusive time of a call (CUDA events);
  * with --variants, the same for the other orderings below, and the host
    time of group.run with 0, 7 and 14 empty collectives; with --timeline,
    the kernels of the replay in time order.
--root imports the port from another checkout (an older commit unpacked
with git archive), so that two commits are compared in one call; the
variants need this checkout's kernels.  Every run's disparity is checked
against K1's full frame.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H, W, D, SHARDS = 376, 1248, 256, 8
CKW = dict(min_disparity=4, num_disparities=D, p1=10, p2=120)
KW = dict(CKW, uniqueness=12, subpixel=True, lr_check=True)
# K5's kernels by profiler name.  (Before the settle kernel had a name of its
# own, the settle sweeps ran as sgm_vpaths_kernel, counted as column paths.)
LABELS = (("sgm_settle_kernel", "settle"), ("sgm_hpaths_kernel", "row paths"),
          ("sgm_vpaths_kernel", "column paths"), ("sgm_wta_kernel", "WTA"))
RUNS, REPLAYS = 5, 20


def union_ms(intervals) -> float:
    total, cs, ce = 0.0, None, None
    for s, e in sorted(intervals):
        if ce is None or s > ce:
            if ce is not None:
                total += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    if ce is not None:
        total += ce - cs
    return total / 1e3


def profiled(fn) -> dict:
    """Span, busy and {label: [ms, launches, union ms]} of K5's kernels in
    one call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = []
    for e in prof.events():
        label = next((lab for pat, lab in LABELS if pat in e.name), None)
        if e.device_type == cuda and label:
            ev.append((label, e.time_range.start, e.time_range.end))
    if not ev:
        return None  # the profiler recorded no K5 kernel in this call
    by = {}
    for _, label in LABELS:
        iv = [(s, e) for lab, s, e in ev if lab == label]
        by[label] = [sum(e - s for s, e in iv) / 1e3, len(iv), union_ms(iv)]
    t0 = min(s for _, s, _ in ev)
    return dict(span=(max(e for _, _, e in ev) - t0) / 1e3,
                busy=union_ms([(s, e) for _, s, e in ev]), by=by,
                timeline=[(lab, (s - t0) / 1e3, (e - t0) / 1e3) for lab, s, e in sorted(
                    ev, key=lambda x: x[1])])


def report(name: str, runs: list, extra: str, tag: str, timeline: bool = False) -> None:
    missed = sum(r is None for r in runs)
    runs = sorted((r for r in runs if r is not None), key=lambda r: r["span"])
    if not runs:
        print(f"{name}: {extra}span and busy not measured (no K5 kernel in the profiles)  "
              f"[{tag}]", flush=True)
        return
    if missed:
        extra += f"{missed} of {missed + len(runs)} profiles without K5 kernels; "
    med = runs[len(runs) // 2]
    by = "; ".join(f"{k} {v[0]:.4f} ms sum, {v[2]:.4f} union ({v[1]})"
                   for k, v in med["by"].items() if v[1])
    spans = ", ".join(f"{r['span']:.4f}" for r in runs)
    print(f"{name}: {extra}span {med['span']:.4f} ms (all {spans}), busy {med['busy']:.4f} ms; "
          f"{by}  [{tag}]", flush=True)
    if timeline:
        print(f"{name}, the run of median span, K5's kernels (start, end ms): "
              + "; ".join(f"{lab} {a:.3f}-{b:.3f}" for lab, a, b in med["timeline"]), flush=True)


class Probe:
    def __init__(self, root: str):
        sys.path.insert(0, root)
        from cartslam_tpu_torch.kernels import build
        from cartslam_tpu_torch.kernels import sgm as ksgm
        from cartslam_tpu_torch.ops import color, stereo
        from cartslam_tpu_torch.parallel.group import ShardGroup
        from cartslam_tpu_torch.runtime.module import SpatialContext
        from cartslam_tpu_torch.sources import SyntheticDataSource

        self.build, self.ksgm = build, ksgm
        self.dev = dev = torch.device("cuda", 0)
        f = SyntheticDataSource(image_size=(H, W), num_frames=1, seed=0, max_disparity=80.0,
                                baseline=20.0).get_next()
        cl, cr = (stereo.census_transform(color.bgr_to_gray(torch.from_numpy(f[v]).to(dev)))
                  for v in ("left", "right"))
        self.k1 = ksgm.sgm_fused(*cl, *cr, **KW)
        self.hl = hl = H // SHARDS
        self.rows = [[c[i * hl:(i + 1) * hl].contiguous() for c in (*cl, *cr)]
                     for i in range(SHARDS)]
        self.group = ShardGroup(SHARDS, [dev] * SHARDS)
        self.sp = SpatialContext(self.group, hl)

    def run(self, fn):
        return self.group.run(fn)

    def measure(self, name: str, fn, tag: str, reset=None, timeline: bool = False) -> None:
        call = lambda: (reset and reset(), self.run(fn))[1]
        if not torch.equal(torch.cat(call()), self.k1):
            raise AssertionError(f"{name}: the disparity differs from K1's full frame")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            torch.cat(call())
        end.record()
        torch.cuda.synchronize()
        host = start.elapsed_time(end) / 10
        report(f"{name}, run", [profiled(call) for _ in range(RUNS)],
               f"host-inclusive {host:.4f} ms a call; ", tag)
        if reset is not None:  # the point-to-point variant waits on host events
            return
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            out = call()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(torch.cat(out), self.k1):
            raise AssertionError(f"{name}: the replayed disparity differs from K1's full frame")
        start.record()
        for _ in range(REPLAYS):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / REPLAYS
        report(f"{name}, replay", [profiled(graph.replay) for _ in range(RUNS)],
               f"{ms:.4f} ms a replay (CUDA events, {REPLAYS}); ", tag, timeline)
        del graph, out
        torch.cuda.empty_cache()

    # --------------------------------------------------------- K5 as kept
    def kept(self, i):
        from cartslam_tpu_torch.parallel.sgm_sharded import sgm_census_sharded

        return sgm_census_sharded(*self.rows[i], self.sp, **KW)

    # ---------------------------------------------- orderings measured too
    def _output(self, i):
        """Fork shard i's output pass: the row paths on its side stream now;
        returns (out, finish(tb, bt), join())."""
        b, ksgm = self.build, self.ksgm
        lib, r, hl = b.library(), [x.data_ptr() for x in self.rows[i]], self.hl
        main, side = torch.cuda.current_stream(), self.group.side_stream()
        out = torch.empty((hl, W), dtype=torch.int16, device=self.dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            vol = ksgm._path_volume(hl, W, D, torch.uint8, self.dev)
        b.check(lib.sgm_sharded_rows(*r, vol.data_ptr(), hl, W, D, 4, 10, 120,
                                     side.cuda_stream), "rows")

        def finish(tb, bt, after=(main,)):
            for s in after:
                side.wait_stream(s)
            if bt is not None:
                bt.record_stream(side)
            b.check(lib.sgm_sharded_cols(*r, vol.data_ptr(), b.ptr(tb), b.ptr(bt), hl, W, D, 4,
                                         10, 120, side.cuda_stream), "cols")
            b.check(lib.sgm_wta(vol.data_ptr(), out.data_ptr(), hl, W, D, 4, 12, 1, 1,
                                side.cuda_stream), "wta")
        return out, finish, lambda: main.wait_stream(side)

    def _settle(self, i, tb, bt, down, up):
        return self.ksgm.sgm_vcarry(*self.rows[i], tb, bt, top_down=down, bottom_up=up, **CKW)

    def first_design(self, i):
        """Two ppermutes (two barriers) a round; the output pass forked after
        the chain returns, so each fork follows the joins of the shards that
        returned before it."""
        from cartslam_tpu_torch.parallel.sgm_sharded import chain_perms

        n, g = SHARDS, self.group
        fwd, bwd = chain_perms(n)
        out, finish, join = self._output(i)
        tb = bt = None
        for j in range(n - 1):
            down, up = i == j, i == n - 1 - j
            tf, bf = self._settle(i, tb, bt, down, up) if down or up else (None, None)
            tr, br = g.ppermute(tf, fwd), g.ppermute(bf, bwd)
            tb = tr if i == j + 1 else tb
            bt = br if i == n - 2 - j else bt
        finish(tb, bt)
        join()
        return out

    def two_chains(self, i):
        """As kept, with the bottom-up sweeps on one stream of their own, so
        that the two chains can overlap."""
        from cartslam_tpu_torch.parallel.sgm_sharded import chain_perms

        n, g = SHARDS, self.group
        fwd, bwd = chain_perms(n)
        main = torch.cuda.current_stream()
        up_stream = self.__dict__.setdefault("up_stream", torch.cuda.Stream(self.dev))
        census = main.record_event()
        out, finish, join = self._output(i)
        tb = bt = None
        settled_at = max(i - 1, n - 2 - i)
        if settled_at < 0:
            finish(tb, bt, (main, up_stream))
        for j in range(n - 1):
            tf = bf = None
            if i == j:
                tf = self._settle(i, tb, None, True, False)[0]
            if i == n - 1 - j:
                up_stream.wait_event(census)
                with torch.cuda.stream(up_stream):
                    bf = self._settle(i, None, bt, False, True)[1]
            tr, br = g.ppermutes((tf, fwd), (bf, bwd))
            tb = tr if i == j + 1 else tb
            bt = br if i == n - 2 - j else bt
            if j == settled_at:
                finish(tb, bt, (main, up_stream))
        g.barrier()
        join()
        return out

    def reset_p2p(self):
        self.mail = {(k, i): [threading.Event(), None] for k in ("tb", "bt")
                     for i in range(SHARDS)}

    def point_to_point(self, i):
        """No barrier: a shard waits only for its own predecessors' carries,
        handing the group's baton on while it waits (host pacing only; the
        card sees the same kernels)."""
        n, g = SHARDS, self.group

        def recv(key):
            ev, _ = self.mail[key]
            if not ev.is_set():
                g._baton.release()
                try:
                    if not ev.wait(60):
                        raise TimeoutError(key)
                finally:
                    g._baton.acquire()
            return self.mail[key][1]

        def send(key, t):
            self.mail[key][1] = t
            self.mail[key][0].set()

        out, finish, join = self._output(i)
        # (round, order, step): sweeps of a round before the carries it hands on
        steps = sorted([(i, 0, "down")] * (i <= n - 2) + [(n - 1 - i, 0, "up")] * (i >= 1)
                       + [(i - 1, 1, "tb")] * (i >= 1) + [(n - 2 - i, 1, "bt")] * (i <= n - 2))
        tb = bt = None
        for k, (rnd, _, step) in enumerate(steps):
            if step == "down" or (step == "up" and (rnd, 0, "down") not in steps):
                down = (rnd, 0, "down") in steps
                up = (rnd, 0, "up") in steps
                tf, bf = self._settle(i, tb, bt, down, up)
                if down:
                    send(("tb", i + 1), tf)
                if up:
                    send(("bt", i - 1), bf)
            elif step == "tb":
                tb = recv(("tb", i))
            elif step == "bt":
                bt = recv(("bt", i))
        finish(tb, bt)
        join()
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose cartslam_tpu_torch is measured")
    ap.add_argument("--variants", action="store_true",
                    help="also the orderings measured against the kept one")
    ap.add_argument("--timeline", action="store_true",
                    help="print the kernels of the kept ordering's replay in time order")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k5_probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tag = f"{smi}; {os.path.abspath(args.root)}"
    p = Probe(args.root)
    p.measure("K5", p.kept, tag, timeline=args.timeline)
    if args.variants:
        g = p.group
        for nb in (0, 7, 14):
            fn = lambda i: [g.barrier() for _ in range(nb)]
            g.run(fn)
            ts = []
            for _ in range(20):
                t0 = time.perf_counter()
                g.run(fn)
                ts.append((time.perf_counter() - t0) * 1e3)
            print(f"group.run with {nb} empty collectives: median {np.median(ts):.3f} ms "
                  f"(min {min(ts):.3f}) host time  [{tag}]", flush=True)
        p.measure("first design", p.first_design, tag)
        p.measure("two chains", p.two_chains, tag)
        p.measure("point to point", p.point_to_point, tag, reset=p.reset_p2p)
        p.measure("K5", p.kept, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
