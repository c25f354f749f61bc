"""The System's spans and device stamps on the card: do the clocks agree,
what does tracing cost, what does a graph hold without it.

    python3 scripts/torch_trace_probe.py [--out DIR] check [--frames N]
    python3 scripts/torch_trace_probe.py [--out DIR] nodes [--root DIR]
    python3 scripts/torch_trace_probe.py [--out DIR] window --workload W --seed S --seconds T --writer 0|1

check: the stamp kernel's resources, the device clock against the host's
(fits of 16 rounds, their error, the drift over a few seconds), then the
flagship at the kitti-planeseg cell's geometry through a traced System with
a profiled stretch of frames: the median gap between each frame's
step-start stamp (device.step, on the host clock) and the first kernel of
its graph replay in the profile, and whether each ``cart.frame.replay``
range encloses its ``cudaGraphLaunch``.
nodes: device operations a replayed frame in the profile, an untraced
System against a traced one (the stamps' nodes and copy); ``--root`` runs
the untraced System of another checkout (the parent) alone.
window: one run of a benchmark cell without the profiler
(``benchmark/harness.run_cell`` with trace off), with or without a
recording TimingWriter given to the System: the result line, and with the
writer every row the System wrote (<out>/trace_rows_<cell>_<seed>.json.gz).  Files go
to ``--out`` (default build/probe/, which git ignores).

Put the card's name and power limit beside every number.
"""

import os
import time

T_START = time.perf_counter()
os.environ["OMP_NUM_THREADS"] = "1"  # as benchmark/run.py

import argparse  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "probe"  # --out
sys.path[0] = str(REPO)  # the checkout's root, not scripts/


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader", "-i", "0"], capture_output=True, text=True)
    return out.stdout.strip()


def _frames(geometry, seed=5, cycle=64):
    import torch

    from benchmark.data.synthetic import SyntheticScene

    scene = SyntheticScene((geometry["height"], geometry["width"]), seed, max_disparity=160,
                           baseline=40, pan_px=2)
    return scene, scene.cycle(cycle, device=torch.device("cuda"))


def _system(n_frames: int, timing=None, max_in_flight=4):
    """The kitti-planeseg cell's System over n_frames synthetic frames."""
    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.sources.base import DataSource

    cfg = json.loads((REPO / "benchmark" / "configs" / "kitti-planeseg.json").read_text())
    scene, frames = _frames(cfg["geometry"])

    class Frames(DataSource):
        def __init__(self):
            super().__init__(image_size=frames[0][0].shape[:2])
            self.intrinsics.q = scene.q
            self.i = 0

        def is_next_ready(self):
            return not self.is_finished()

        def is_finished(self):
            return self.i >= n_frames

        def get_next(self):
            left, right = frames[self.i % len(frames)]
            self.i += 1
            return {"left": left, "right": right}

    return build_system(Frames(), cfg["modules"], device="cuda", max_in_flight=max_in_flight,
                        extra_fetch_keys=["planes"], timing=timing,
                        snapshot_interval=cfg["system"]["snapshot_interval"])


def _profiled_run(system, first: int, last: int):
    """Run the System, profiling frames first..last (started and stopped
    in on_frame, as the harness does): (kineto events, wall s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_frame(fid, _):
        if fid == first:
            torch.cuda.synchronize()
            prof.start()
            marks["t0"] = time.perf_counter()
        elif fid == last:
            torch.cuda.synchronize()
            marks["wall"] = time.perf_counter() - marks["t0"]
            prof.stop()

    system.run(on_frame)
    return list(prof.profiler.kineto_results.events()), marks["wall"]


def _ev(e):
    s = e.start_ns() / 1e3 if hasattr(e, "start_ns") else float(e.start_us())
    d = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else float(e.duration_us())
    return s, s + d


def _device_ops(events, cuda) -> list:
    return [e for e in events if e.device_type() == cuda and _ev(e)[1] > _ev(e)[0]]


def check(args) -> None:
    import torch

    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.kernels.stamp import stamp
    from cartslam_tpu_torch.runtime.timing import fit_clock

    print(f"card {card()}; python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; host_memory_stats "
          f"{hasattr(torch.cuda, 'host_memory_stats')}", flush=True)
    info = build.build()
    res = [k for k in build.kernel_resources(info.report.read_text()) if "stamp" in k["name"]]
    print(f"library built in {info.seconds:.1f} s; stamp kernel {res}", flush=True)
    if hasattr(torch.cuda, "host_memory_stats"):
        print("host_memory_stats keys:", sorted(torch.cuda.host_memory_stats())[:40])

    row = torch.zeros(16, dtype=torch.int64, device="cuda")
    h0 = time.time_ns()
    stamp(row, 0)
    torch.cuda.synchronize()
    h1 = time.time_ns()
    print(f"globaltimer - time.time_ns: {int(row[0]) - (h0 + h1) // 2} ns "
          f"(host interval {h1 - h0} ns)")
    fits = []
    for _ in range(3):
        fits.append(fit_clock(lambda i: stamp(row, i), torch.cuda.synchronize, row.tolist, 16))
        time.sleep(1.0)
    print("clock fits (offset ns, error ns), 1 s apart:",
          [(f.offset_ns, f.error_ns) for f in fits], flush=True)

    from benchmark import harness

    rec = harness._timing_writer(__import__(
        "cartslam_tpu_torch.runtime.timing", fromlist=["TimingWriter"]).TimingWriter)
    system = _system(args.frames, rec)
    first, last = args.frames - 60, args.frames - 20
    events, wall = _profiled_run(system, first, last)
    print("system clock fits:", [(f.offset_ns, f.error_ns) for f in system.clock_fits],
          "counters", system.counters, flush=True)
    cuda = torch.autograd.DeviceType.CUDA
    device = _device_ops(events, cuda)
    host = [e for e in events if e.device_type() != cuda]
    launches = {e.correlation_id(): _ev(e) for e in host if e.name() == "cudaGraphLaunch"}
    first_kernel = {}
    for e in sorted(device, key=lambda e: _ev(e)[0]):
        c = next((c for c in (e.correlation_id(), e.linked_correlation_id()) if c in launches),
                 None)
        if c is not None and c not in first_kernel:
            first_kernel[c] = (e.name(), _ev(e)[0])
    replays = [_ev(e) for e in host if e.name() == "cart.frame.replay"]
    enclosing = sum(1 for s, e in replays
                    if sum(1 for ls, le in launches.values() if s <= ls and le <= e) == 1)
    print(f"profiled frames {first}..{last}: {len(replays)} cart.frame.replay ranges, "
          f"{len(launches)} cudaGraphLaunch, {enclosing} ranges enclose exactly one launch",
          flush=True)
    kstarts = sorted(t for _, t in first_kernel.values())
    names = sorted({n[:40] for n, _ in first_kernel.values()})
    gaps = []
    for name, fid, _, start, _ in rec.rows:
        if name == "device.step" and first + 4 <= fid <= last and kstarts:
            s_us = start * 1e3
            gaps.append(min((s_us - k for k in kstarts), key=abs))
    if gaps:
        print(f"step-start stamp - first kernel of the replay: {len(gaps)} frames, median "
              f"{statistics.median(gaps):.2f} us, |max| {max(map(abs, gaps)):.2f} us; first "
              f"kernels {names}", flush=True)
    ops = len(device) / (last - first)
    print(f"device ops a frame (traced) {ops:.2f}; wall {wall:.3f} s", flush=True)
    by_name = {}
    for name, fid, _, s, e in rec.rows:
        if first - 40 <= fid < first:  # unprofiled frames
            by_name.setdefault(name, []).append(e - s)
    for name, v in sorted(by_name.items()):
        print(f"  {name:32s} median {statistics.median(v):8.3f} ms over {len(v)}")
    OUT.mkdir(parents=True, exist_ok=True)
    with gzip.open(OUT / "trace_check_rows.json.gz", "wt") as f:
        json.dump(rec.rows, f)


def nodes(args) -> None:
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import cartslam_tpu_torch

    print(f"card {card()}; program {Path(cartslam_tpu_torch.__file__).parent}", flush=True)
    cuda = torch.autograd.DeviceType.CUDA
    modes = [("untraced", None)]
    if not args.root:
        from cartslam_tpu_torch.runtime.timing import TimingWriter

        class Rows(TimingWriter):
            def __init__(self):
                super().__init__(enabled=False)

            def end_timing_at(self, handle):
                pass

        modes.append(("traced", Rows()))
    for mode, writer in modes:
        system = _system(120, writer)
        events, _ = _profiled_run(system, 80, 100)
        device = _device_ops(events, cuda)
        kinds, names = {}, {}
        for e in device:
            k = "memcpy" if e.name().startswith("Memcpy") else "memset" if \
                e.name().startswith("Memset") else "stamp" if "stamp" in e.name() else "kernel"
            kinds[k] = kinds.get(k, 0) + 1
            names[e.name()[:100]] = names.get(e.name()[:100], 0) + 1
        OUT.mkdir(parents=True, exist_ok=True)
        tag = "parent" if args.root else "change"
        (OUT / f"trace_nodes_{tag}_{mode}.json").write_text(json.dumps(names, indent=0))
        if mode == "traced":
            stamp_us = sum(_ev(e)[1] - _ev(e)[0] for e in device if "stamp" in e.name()) / 20
            print(f"stamp kernels: {stamp_us:.2f} device us a frame", flush=True)
            plain = json.loads((OUT / "trace_nodes_change_untraced.json").read_text())
            diff = {n: (names.get(n, 0) - plain.get(n, 0)) / 20 for n in set(names) | set(plain)
                    if names.get(n, 0) != plain.get(n, 0)}
            print("traced - untraced, a frame:", json.dumps(diff, indent=0), flush=True)
        print(f"{mode}: {len(device) / 20:.2f} device ops a frame over frames 80..100 "
              f"({ {k: v / 20 for k, v in sorted(kinds.items())} }); launches a graph "
              f"{ {str(k[0]): sum(s.launches.values()) for k, s in system.pipeline.captured_steps.items()} }",
              flush=True)
        del system
        torch.cuda.empty_cache()
    if not args.root:
        from cartslam_tpu_torch.runtime.timing import Span, now_ms

        n, spans = 100_000, {}
        for label, target in (("now_ms()", None), ("Span, traced", spans),
                              ("Span, untraced", None)):
            t0 = time.perf_counter()
            for _ in range(n):
                if label == "now_ms()":
                    now_ms()
                else:
                    with Span(target, "frame.x"):
                        pass
            print(f"host: {label} {(time.perf_counter() - t0) / n * 1e6:.3f} us", flush=True)


def window(args) -> None:
    from benchmark import harness

    held = {}

    def patch():
        from cartslam_tpu_torch.runtime import system as sysmod
        from cartslam_tpu_torch.runtime.timing import TimingWriter

        init = sysmod.System.__init__

        def with_writer(self, *a, **kw):
            kw["timing"] = held["writer"] = harness._timing_writer(TimingWriter)
            init(self, *a, **kw)
            held["system"] = self

        sysmod.System.__init__ = with_writer

    def log(msg):
        print(f"[probe {time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr,
              flush=True)

    result = harness.run_cell(REPO, args.workload, args.seed, args.seconds, False, "cuda",
                              T_START, log, patch if args.writer else None)
    result["writer"] = bool(args.writer)
    if args.writer:
        OUT.mkdir(parents=True, exist_ok=True)
        path = OUT / f"trace_rows_{args.workload}_{args.seed}.json.gz"
        with gzip.open(path, "wt") as f:
            json.dump(held["writer"].rows, f)
        log(f"{len(held['writer'].rows)} rows in {path.name}")
        system = held["system"]
        log(f"clock fits (offset ns, error ns) at the start and the end: "
            f"{[(f.offset_ns, f.error_ns) for f in system.clock_fits]}; counters "
            f"{system.counters}")
    harness.print_result(result)


def main() -> None:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT), help="where the probe writes its files")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check")
    c.add_argument("--frames", type=int, default=200)
    n = sub.add_parser("nodes")
    n.add_argument("--root", default=None)
    w = sub.add_parser("window")
    w.add_argument("--workload", required=True)
    w.add_argument("--seed", type=int, required=True)
    w.add_argument("--seconds", type=float, default=20.0)
    w.add_argument("--writer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    OUT = Path(args.out).resolve()
    {"check": check, "nodes": nodes, "window": window}[args.cmd](args)


if __name__ == "__main__":
    main()
