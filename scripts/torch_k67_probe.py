#!/usr/bin/env python3
"""K6 (the 4-path aggregated volume) and K7 (the label tally) of
cartslam_tpu_torch on one GPU, timed, so that two checkouts are compared in
one call.

    python3 scripts/torch_k67_probe.py [--root DIR]

On a synthetic 376x1248 frame, D = 256 (p1 10, p2 120, min disparity 4),
and its 3329 12x12-block labels, prints, each beside the card's name and
power limit:
  * K6: ms a call of kernels/sgm.sgm_aggregate (CUDA events, mean of 20
    calls), and ms a call of a replayed CUDA graph of 10 calls; the peak
    device memory a call allocates; its device time by kernel (row paths,
    column paths, and a summing pass where the checkout has one) from
    torch.profiler over 5 calls; the output held against the plain version;
  * K7 at 19 columns (the rows [1, d, d^2] of 9 integer channels): device ms
    a call (CUDA events around a replayed graph of 100 wrapper calls), the
    wrapper's ms (host work included), index_add_ int64's device ms the same
    way, and the same for the whole 9-channel ops/superpixels.init_stats
    call; the table held against the plain version;
  * K1: ms a call of kernels/sgm.sgm_fused.
--root imports the port from another checkout (an older commit unpacked
with git archive); the checkout's K7 wrapper is called in its own layout
(flat [B] labels and [B, C] values before the channel-major one).  Each
root builds its kernels into its own build/ directory.  Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

H, W, D = 376, 1248, 256
AKW = dict(min_disparity=4, num_disparities=D, p1=10, p2=120)
K6_KERNELS = (("sgm_hpaths_kernel", "row paths"), ("sgm_vpaths", "column paths"),
              ("sgm_sum4", "summing pass"))


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 100, replays: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def by_kernel(fn, calls: int = 5) -> dict:
    """{label: (device ms a call, launches a call)} of K6's kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        label = next((lab for pat, lab in K6_KERNELS if pat in e.name), None)
        if e.device_type == cuda and label:
            ms, n = out.get(label, (0.0, 0))
            out[label] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    return {k: (ms / calls, n / calls) for k, (ms, n) in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose cartslam_tpu_torch is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k67_probe: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    tag = f"{smi.stdout.strip().splitlines()[0]}; {os.path.abspath(args.root)}"
    sys.path.insert(0, os.path.abspath(args.root))
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.kernels import sgm as ksgm
    from cartslam_tpu_torch.kernels import tally as ktally
    from cartslam_tpu_torch.ops import color, stereo
    from cartslam_tpu_torch.ops import superpixels as sp
    from cartslam_tpu_torch.sources import SyntheticDataSource

    dev = torch.device("cuda", 0)
    info = build.build()
    build.library()
    for k in build.kernel_resources(info.report.read_text()):
        if k["name"].startswith("sgm_") and "wta" not in k["name"]:
            print(f"ptxas: {k}", flush=True)
    f = SyntheticDataSource(image_size=(H, W), num_frames=1, seed=0, max_disparity=80.0,
                            baseline=20.0).get_next()
    left = torch.from_numpy(f["left"]).to(dev)
    gl = color.bgr_to_gray(left)
    gr = color.bgr_to_gray(torch.from_numpy(f["right"]).to(dev))
    census = (*stereo.census_transform(gl), *stereo.census_transform(gr))

    # K6
    out = ksgm.sgm_aggregate(*census, **AKW)
    if not torch.equal(out, ksgm.sgm_aggregate_plain(*census, **AKW)):
        raise AssertionError("K6 differs from its plain version")
    del out
    torch.cuda.empty_cache()
    k6 = lambda: ksgm.sgm_aggregate(*census, **AKW)
    ms = cuda_ms(k6, 20)
    dms = graph_ms(k6, calls=10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    k6()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    split = by_kernel(k6)
    print(f"K6 sgm_aggregate [{H},{W}] D={D}: {ms:.4f} ms a call, graph replay {dms:.4f} ms; "
          f"peak {peak:.1f} MiB a call; by kernel: "
          + "; ".join(f"{k} {v[0]:.4f} ms ({v[1]:g} launches)" for k, v in split.items())
          + f"  [{tag}]", flush=True)
    torch.cuda.empty_cache()
    # K7, and the 9-channel init_stats call that routes to it
    labels, top = sp.block_init_labels(H, W, 12, 12, dev)
    num = top + 1
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    gen = torch.Generator(device=dev).manual_seed(3)
    deriv = torch.randint(-300, 301, (3, H, W), generator=gen, device=dev, dtype=torch.int32)
    deriv[torch.rand((3, H, W), generator=gen, device=dev) < 0.05] = -32768
    data9 = torch.cat([color.bgr_to_ycrcb(left).permute(2, 0, 1).float(), gl[None].float(),
                       torch.stack([xs, ys]).float(), deriv.float()]).contiguous()
    d9 = data9.to(torch.int32)
    rows = torch.cat([torch.ones_like(d9[:1]), d9, d9 * d9]).contiguous()  # [19, H, W]
    c = rows.shape[0]
    flat, rows_bc = labels.reshape(-1), rows.reshape(c, -1).T.contiguous()
    want = ktally.label_tally_plain(flat, rows_bc, num)  # [L, C]
    if len(build.SIGNATURES["label_tally"]) == 8:  # before the channel-major K7
        k7 = lambda: ktally.label_tally(flat, rows_bc, num)
        got = k7()
    else:
        k7 = lambda: ktally.label_tally(labels, rows, num)
        got = k7().T
    if not torch.equal(got, want):
        raise AssertionError("K7 differs from its plain version")
    stats = sp.init_stats(labels, data9, num)
    if stats.shape != (c, num) or int(stats[0].sum()) != H * W:
        raise AssertionError("init_stats with 9 channels: wrong table")
    idx64, vals64 = flat.long(), rows_bc.long()
    acc = torch.zeros((num, c), dtype=torch.int64, device=dev)
    init = lambda: sp.init_stats(labels, data9, num)
    k7_dms, k7_ms = graph_ms(k7), cuda_ms(k7, 50)
    lib_dms = graph_ms(lambda: acc.index_add_(0, idx64, vals64))
    init_dms, init_ms = graph_ms(init), cuda_ms(init, 50)
    print(f"K7 label_tally C={c}, B={H * W}, L={num} (the block grid): device {k7_dms:.4f} ms, "
          f"wrapper {k7_ms:.4f} ms; index_add_ int64 device {lib_dms:.4f} ms; 9-channel "
          f"init_stats device {init_dms:.4f} ms, wrapper {init_ms:.4f} ms  [{tag}]", flush=True)

    # K1
    kw = dict(AKW, uniqueness=12, subpixel=True, lr_check=True)
    k1 = cuda_ms(lambda: ksgm.sgm_fused(*census, **kw), 20)
    print(f"K1 sgm_fused [{H},{W}] D={D}: {k1:.4f} ms a call  [{tag}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
