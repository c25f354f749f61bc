#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure):
  1. device  - require CUDA; print the card's name and power limit.
  2. build   - compile the CUDA kernels from csrc/ with nvcc (sm_90a).
  3. kernels - each kernel against its plain PyTorch version on the card, at
               the flagship slice's shapes (376x1248, 256 disparities).
  4. slice   - the non-temporal kitti-planeseg flagship (disparity ->
               derivative -> depth -> superpixels -> superpixel plane
               segmentation) for 65 synthetic frames through the config
               registry and the run loop, with every kernel's launch count
               checked; a small-input run on the card against the same run
               on the CPU; disparity against the synthetic ground truth;
               then a profiled run of frames 3..12 (per-module CUDA-event
               spans, device busy time and idle share, device time by
               kernel name, all from that one run).
  5. cli     - configs/synthetic-planeseg.json through the CLI entry point.
  6. times   - per-frame ms and each kernel's ms beside its plain version's.
The last two lines of standard output are the kernels JSON line and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, D = 376, 1248, 256
FRAMES = 65
# K3 labels could differ from the plain version's only where torch's CUDA log
# and the kernel's logf round one value differently and so flip a strict-<
# tie.  Both call the same logf, and every run so far showed 0, so the bound
# is 0: a run that shows a flip is the case to record before loosening it.
RELAX_LABEL_BOUND = 0
# Frames of the profiled run (normal variant, no provider update, no reset).
PROFILE_FRAMES = (3, 12)

KERNELS = {
    "sgm": ("cartslam_tpu_torch/csrc/sgm.cu", "cartslam_tpu/ops/pallas/sgm.py:654"),
    "moment_tally": ("cartslam_tpu_torch/csrc/tally.cu", "cartslam_tpu/ops/pallas/tally.py:231"),
    "relax": ("cartslam_tpu_torch/csrc/relax.cu", "cartslam_tpu/ops/pallas/relax.py:240"),
    "vote_tally": ("cartslam_tpu_torch/csrc/tally.cu", "cartslam_tpu/ops/pallas/tally.py:102"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def slice_modules() -> list[dict]:
    """configs/kitti-planeseg.json's modules, cut to the non-temporal slice."""
    with open(os.path.join(REPO, "configs", "kitti-planeseg.json")) as f:
        mods = json.load(f)["modules"]
    out = []
    for m in mods:
        if m["type"] == "optflow" or m["type"].endswith("_visualization"):
            continue
        if m["type"] == "superpixel_disparity_planeseg":
            m = {**m, "use_temporal_smoothing": False}
        out.append(m)
    return out


def kernel_phase(dev, tag):
    """Each kernel vs its plain version at the slice's shapes."""
    from cartslam_tpu_torch.kernels import relax as krelax
    from cartslam_tpu_torch.kernels import sgm as ksgm
    from cartslam_tpu_torch.kernels import tally as ktally
    from cartslam_tpu_torch.ops import color, derivative, disparity, planeseg, stereo
    from cartslam_tpu_torch.ops import superpixels as sp
    from cartslam_tpu_torch.sources import SyntheticDataSource

    src = SyntheticDataSource(image_size=(H, W), num_frames=1, seed=0,
                              max_disparity=80.0, baseline=20.0)
    f = src.get_next()
    left = torch.from_numpy(f["left"]).to(dev)
    right = torch.from_numpy(f["right"]).to(dev)
    results = {}

    # K1
    cl = stereo.census_transform(color.bgr_to_gray(left))
    cr = stereo.census_transform(color.bgr_to_gray(right))
    kw = dict(min_disparity=4, num_disparities=D, p1=10, p2=120, uniqueness=12,
              subpixel=True, lr_check=True)
    out_k = ksgm.sgm_fused(*cl, *cr, **kw)
    out_p = stereo.sgm_from_census_plain(*cl, *cr, **kw)
    if not torch.equal(out_k, out_p):
        n = int((out_k != out_p).sum())
        raise AssertionError(f"K1 sgm: {n} pixels differ from the plain version")
    err = float((out_k.int() - out_p.int()).abs().max())
    ms = cuda_ms(lambda: ksgm.sgm_fused(*cl, *cr, **kw), 20)
    pms = cuda_ms(lambda: stereo.sgm_from_census_plain(*cl, *cr, **kw), 2)
    results["sgm"] = (err, ms, pms)
    log(f"K1 sgm: array_equal at [{H},{W}] D={D}; kernel {ms:.3f} ms, plain {pms:.3f} ms  [{tag}]")

    # Inputs of K2..K4 as the slice builds them.
    disp = disparity.interpolate(out_k, radius=2, iterations=1, min_disparity=64, max_disparity=W)
    deriv, _ = derivative.directional_derivatives(disp)
    img = color.bgr_to_ycrcb(left).to(torch.float32)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    data = torch.cat([deriv.permute(2, 0, 1).float(), img.permute(2, 0, 1),
                      torch.stack([xs, ys]).float()]).contiguous()
    labels, max_label = sp.block_init_labels(H, W, 12, 12, dev)
    num_labels = max_label + 1
    flat = labels.reshape(-1).contiguous()
    data_i = data.reshape(7, -1).to(torch.int32).contiguous()

    # K2
    tk = ktally.moment_tally(flat, data_i, num_labels)
    tp = ktally.moment_tally_plain(flat, data_i, num_labels)
    if not torch.equal(tk, tp):
        raise AssertionError(f"K2 moment tally: {int((tk != tp).sum())} entries differ")
    ms = cuda_ms(lambda: ktally.moment_tally(flat, data_i, num_labels), 50)
    pms = cuda_ms(lambda: ktally.moment_tally_plain(flat, data_i, num_labels), 10)
    results["moment_tally"] = (float((tk - tp).abs().max()), ms, pms)
    log(f"K2 moment_tally: array_equal [{tk.shape[0]},{num_labels}] from N={flat.numel()}; "
        f"kernel {ms:.3f} ms, plain {pms:.3f} ms  [{tag}]")

    # K3: one sweep from identical inputs.
    feats = [krelax.RelaxFeature("gaussian", 0, 2, 1.0), krelax.RelaxFeature("gaussian", 2, 3, 1.5),
             krelax.RelaxFeature("compactness", 5, 2, 0.1)]
    stat_img = tk[:, flat.long()].reshape(-1, H, W).contiguous()
    pix = torch.cat([torch.ones(1, H, W, device=dev), data, data * data]).contiguous()
    args = (labels, stat_img, pix, feats, 7, 0.5, 0.5 / np.sqrt(2))
    lk, sk = krelax.relax_sweep(*args)
    lp, spl = krelax.relax_sweep_plain(*args)
    ndiff = int((lk != lp).sum())
    moved = int((lk != labels).sum())
    log(f"K3 relax: {ndiff} label pixels differ from the plain version (bound "
        f"{RELAX_LABEL_BOUND}); {moved} pixels relabelled by the sweep")
    if ndiff > RELAX_LABEL_BOUND or moved == 0:
        raise AssertionError("K3 relax disagrees with its plain version")
    same = (lk == lp)[None].expand_as(sk)
    if not torch.equal(sk[same], spl[same]):
        raise AssertionError("K3 relax: stat rows differ where labels agree")
    ms = cuda_ms(lambda: krelax.relax_sweep(*args), 50)
    pms = cuda_ms(lambda: krelax.relax_sweep_plain(*args), 3)
    results["relax"] = (float((lk - lp).abs().max()), ms, pms)
    log(f"K3 relax: kernel {ms:.3f} ms, plain {pms:.3f} ms per sweep  [{tag}]")

    # K4
    ranges = torch.tensor([[3, 40], [-6, 3]], dtype=torch.int32, device=dev)
    votes = planeseg.classify(deriv[..., 0], ranges).reshape(-1).contiguous()
    vlabels = lk.reshape(-1).contiguous()
    ck = ktally.vote_tally(vlabels, votes, num_labels, 3)
    cp = ktally.vote_tally_plain(vlabels, votes, num_labels, 3)
    if not torch.equal(ck, cp):
        raise AssertionError("K4 vote tally differs from the plain version")
    ms = cuda_ms(lambda: ktally.vote_tally(vlabels, votes, num_labels, 3), 50)
    pms = cuda_ms(lambda: ktally.vote_tally_plain(vlabels, votes, num_labels, 3), 10)
    results["vote_tally"] = (float((ck - cp).abs().max()), ms, pms)
    log(f"K4 vote_tally: array_equal [{num_labels},3]; kernel {ms:.3f} ms, plain {pms:.3f} ms  [{tag}]")
    return results


def small_slice_check(dev):
    """A 64x128 slice for 6 frames on the card and on the CPU: kernels vs
    plain versions end to end, every output equal (depth within ~3 ulp).
    48 disparities from 0, as in configs/synthetic-planeseg.json, so K1's
    last lane chunk is partial."""
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.runtime import run, state_to_numpy
    from cartslam_tpu_torch.sources import SyntheticDataSource

    mods = [
        {"type": "disparity", "num_disparities": 48, "min_disparity": 0,
         "smoothing_radius": 2, "smoothing_iterations": 1},
        {"type": "disparity_derivative"},
        {"type": "depth"},
        {"type": "superpixels", "initial_iterations": 3, "iterations": 2, "block_size": 8,
         "reset_iterations": 4},
        {"type": "superpixel_disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
         "update_interval": 3},
    ]
    outs = {}
    for device in ("cpu", dev):
        src = SyntheticDataSource(image_size=(64, 128), num_frames=6, seed=0,
                                  max_disparity=22.4, baseline=20.0)
        pipe, src = build_pipeline(src, mods, device=device)
        frames = []
        run(pipe, src, on_frame=lambda fid, o: frames.append(state_to_numpy(o)))
        outs[str(device)] = frames
    for fid, (a, b) in enumerate(zip(outs["cpu"], outs[str(dev)]), start=1):
        for k in a:
            if k == "depth":
                # Elementwise IEEE ops in the same order on both devices; the
                # relative bound (~3 ulp) only guards against a reordering.
                fin = np.isfinite(a[k])
                if not (np.array_equal(np.isfinite(b[k]), fin)
                        and np.allclose(a[k][fin], b[k][fin], rtol=4e-7, atol=0)):
                    raise AssertionError(f"small slice frame {fid}: depth differs")
            elif not np.array_equal(a[k], b[k]):
                n = int((a[k] != b[k]).sum())
                raise AssertionError(f"small slice frame {fid}: {k} differs card vs CPU "
                                     f"on {n} of {a[k].size} values")
    log("small slice (64x128, D=48, 6 frames): card == CPU on every output "
        "(superpixels and planes exact, depth within ~3 ulp)")


def _union_ms(intervals) -> float:
    """Total length of the union of (start_us, end_us) intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def profile_phase(frames, intrinsics, dev, tag):
    """Where the time goes, all from ONE run of a fresh slice pipeline:
    frames PROFILE_FRAMES under torch.profiler, with CUDA events around each
    module's compute.  The device's busy time is the union of the profiler's
    device intervals (kernels, copies, memsets) in the window; its idle share
    is 1 - busy / the window's host wall time, both taken with the profiler
    on.  Prints "not measured" where the profiler saw no device activity."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.runtime import run
    from cartslam_tpu_torch.sources import PreloadedSource

    first, last = PROFILE_FRAMES
    pipe, source = build_pipeline(PreloadedSource(frames[:last], intrinsics=intrinsics),
                                  slice_modules(), device=dev)
    spans = {m.name: [] for m in pipe.modules}

    def timed(m):
        compute = m.compute

        def wrapper(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = compute(*args, **kw)
            b.record()
            spans[m.name].append((a, b))
            return out
        return wrapper

    for m in pipe.modules:
        m.compute = timed(m)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_frame(fid, _):
        if fid == first - 1:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif fid == last:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    run(pipe, source, on_frame=on_frame)
    n = last - first + 1
    wall = window["wall_ms"] / n
    med = {name: float(np.median([a.elapsed_time(b) for a, b in ev[first - 1:]]))
           for name, ev in spans.items()}
    log(f"profile frames {first}..{last}: per-module device span median (CUDA events "
        f"around compute, launch gaps included): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(med.items(), key=lambda kv: -kv[1]))
        + f"  [{tag}]")
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    if not dev_events:
        log(f"profile frames {first}..{last}: wall {wall:.3f} ms/frame (profiler on); "
            f"device busy and idle share not measured (no device events)  [{tag}]")
        return
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in dev_events) / n
    log(f"profile frames {first}..{last}: wall {wall:.3f} ms/frame (profiler on), device "
        f"busy {busy:.3f} ms/frame, idle share {1 - busy / wall:.4f} "
        f"({len(dev_events)} device events)  [{tag}]")
    by_name: dict[str, list] = {}
    for e in dev_events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    log(f"profile frames {first}..{last}: device ms per frame by name: "
        + "; ".join(f"{k[:60]} {sum(v) / 1e3 / n:.3f} ({len(v) / n:g}/frame)" for k, v in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.runtime import run
    from cartslam_tpu_torch.sources import PreloadedSource, SyntheticDataSource

    # 1. device
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    tag = f"{torch.cuda.get_device_name(0)}, {card.split(',')[-1].strip()}"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")

    # 2. build
    info = build.build()
    build.library()
    sources = ", ".join(sorted(os.path.basename(p) for p in map(str, build.source_files())))
    log(f"build: {'compiled' if info.built else 'loaded'} {info.path.name} from csrc/ "
        f"({sources}) in {info.seconds:.2f} s")

    # 3. kernels vs plain versions
    results = kernel_phase(dev, tag)

    # 4. the slice
    gen = SyntheticDataSource(image_size=(H, W), num_frames=FRAMES, seed=0,
                              max_disparity=80.0, baseline=20.0)
    source = PreloadedSource.wrap(gen)
    pipe, source = build_pipeline(source, slice_modules(), device=dev)
    log("slice modules: " + " -> ".join(m.name for m in pipe.modules))
    events, last = [], {}

    def on_frame(fid, outputs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        for k, v in outputs.items():
            if v.device.type != "cuda":
                raise AssertionError(f"frame {fid}: output {k} is on {v.device}")
        last.update(outputs)

    build.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    res = run(pipe, source, on_frame=on_frame)
    torch.cuda.synchronize()
    counts = {c.name: (c.launches, c.plain_calls) for c in build.COUNTERS.values()}
    log(f"slice: {res.frames} frames at {H}x{W}, D={D}; launches/plain calls {counts}")
    if res.frames != FRAMES:
        raise AssertionError(f"ran {res.frames} frames, expected {FRAMES}")
    for name in KERNELS:
        launches, plain = counts[name]
        if launches == 0 or plain != 0:
            raise AssertionError(f"kernel {name}: {launches} launches, {plain} plain calls")
    planes = last["planes"]
    vals = set(torch.unique(planes).tolist())
    if planes.shape != (H, W) or planes.dtype != torch.uint8 or not vals <= {0, 1, 2}:
        raise AssertionError(f"planes: shape {tuple(planes.shape)}, values {vals}")
    ranges = res.host_params["SPPlaneSegmentation"]["ranges"].tolist()
    hist = np.bincount(planes.cpu().numpy().ravel(), minlength=3).tolist()
    log(f"planes classes {hist} (H, V, U); provider ranges {ranges}")
    # Disparity against the synthetic ground truth, where the slice can
    # report one: above minD and below the smoothing's validity bound (the
    # image width in x16 units, i.e. 78 px here; sky and the near wall fall
    # outside it).
    disp = last["disparity"].cpu().numpy()
    gt = gen.ground_truth_disparity(FRAMES - 1)
    region = (gt > 5) & (gt < (W - 16) / 16)
    valid = (disp != -32768) & region
    err = np.abs(disp[valid] / 16.0 - gt[valid])
    cover, within = float(valid.sum() / region.sum()), float((err <= 1.0).mean())
    log(f"disparity vs ground truth (frame {FRAMES}): {region.mean():.4f} of pixels in range, "
        f"valid on {cover:.4f} of them, |err| <= 1 px on {within:.4f} of valid")
    depth = last["depth"].cpu().numpy()
    if cover < 0.5 or within < 0.8 or not np.isfinite(depth[valid]).all():
        raise AssertionError("slice disparity/depth out of bounds")
    frame_ms = [start.elapsed_time(events[0])]
    frame_ms += [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]

    small_slice_check(dev)
    profile_phase(source.frames, source.get_camera_intrinsics(), dev, tag)

    # 5. the CLI path
    from cartslam_tpu_torch.__main__ import main as cli_main

    cfg = os.path.join(REPO, "configs", "synthetic-planeseg.json")
    if cli_main([cfg, "--device", "cuda", "--max-frames", "5"]) != 0:
        raise AssertionError("CLI run failed")
    log("cli: configs/synthetic-planeseg.json --device cuda --max-frames 5 OK")

    # 6. times
    steady = frame_ms[2:]
    log(f"slice per-frame ms: median {float(np.median(steady)):.3f} over frames 3..{FRAMES} "
        f"(min {min(steady):.3f}, max {max(steady):.3f}); frame 1 {frame_ms[0]:.3f}, "
        f"frame 64 (reset) {frame_ms[63]:.3f}  [{tag}]")
    for name, (err_, ms, pms) in results.items():
        log(f"{name}: kernel {ms:.4f} ms, plain {pms:.4f} ms  [{tag}]")

    kernels = []
    for name, (src, replaces) in KERNELS.items():
        err_, ms, pms = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name][0], "max_abs_err": err_,
                        "ms": ms, "plain_ms": pms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
