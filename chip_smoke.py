#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure; none is caught):
  1. device   - require CUDA; print the card's name and power limit.
  2. build    - compile the CUDA kernels from csrc/ with nvcc (sm_90a); print
                ptxas's registers, shared memory and spill bytes of the SGM
                path and WTA kernels (K6's accumulate forms among them), the
                relax kernels and the K2 / K4 / K7 tally kernels, and fail if
                the flagship's instantiation of the fused relax kernel, or a
                tally kernel a path runs, spills.
  3. kernels  - each kernel against its plain PyTorch version on the card, at
                the flagship's shapes (376x1248, 256 disparities, 3329
                labels), with its time, the plain version's, the time of one
                PyTorch library call computing the same function where there
                is one, and the least time the card could take (bound).  The
                SGM stages (census, K6 aggregate, K1 fused, K1's path and WTA
                kernels alone) are timed side by side.  K1 is also held
                against its plain version on uniform random 31-bit census
                words (many tied costs), at D=64 and on a 37x61 crop with
                D=15 and p2=193 and with D=100, each with the LR check and
                the subpixel step on and off.  K3 (all sweeps of a call in
                fused launches) is held against its plain version for 1, 8
                and 24 sweeps from the block grid and from the labels after
                24 sweeps, labels and stat image, and timed at 1-24 sweeps a
                launch through its C entry points, with one phase and two.
                K3's generic instantiation (the grayscale layout), its
                progressive factor, two phases in 'frame' stats mode (both
                instantiations), a 'phase'-stats call (one sub-step a
                launch, a fresh K2 table each) and a shard with row0 < 0
                against the plain versions, 0 differing labels; a
                'phase'-mode launch timed.
                K6 array_equal to its plain version at the flagship's shape
                (p2 120 and p2 8000) and on odd and even crops (an odd W's
                middle cell, an odd H's middle row, D = 15, 33, 100, 50 with
                masked scalar stores), synthetic and random census; its time
                and the peak device memory of a call.
                K7 array_equal to its plain version at 19 and 50 columns on
                the image and flat layouts of two label images, +-2^30 in
                every column, random labels that overflow the slot map, an
                unaligned ragged flat N and the psum of two halves; its
                device time (graph replay, as K2's) beside index_add_
                int64's device time.
                K2 and K4 array_equal to their plain versions on the
                flagship's labels and on hard layouts
                (random labels over [-2, L+2), one label, every label
                dropped, the faithful flagship's labels after 8 sub-steps, a
                ragged unaligned flat N, K2's data at -32768 and at 32767,
                the psum of two halves' tables), and their device time a call
                from CUDA events around the replay of a CUDA graph of 100
                wrapper calls, beside the wrapper's time.
                K5 (the height-sharded SGM) runs on 8 shards of 47 rows of
                the same frame, the shards as threads on this one card: the
                carries of its exact settle schedule (14 one-direction
                sweeps) against its plain version and against the
                all-shards schedule replayed with the kernel's
                both-directions sweep, shard outputs against its plain
                version, and the 8 shards' disparity against K1's full
                frame; its device span, busy time and time by kernel a
                frame from torch.profiler, beside the host-inclusive time
                of the call and K1's time in the same call.  K2, K3
                and K4 at the spatial path's shard shapes (47 rows, and 63
                and 95 rows with the superpixels' halos) against their plain
                versions, K2's and K4's psum'd tables against the full
                frame's.
  4. paths    - each path driven with the launch counts set to 0 just before
                it and read just after:
                  * K6's entry point (kernels/sgm.sgm_aggregate) once;
                  * K7's entry point (ops/superpixels.init_stats with 9
                    channels) once;
                  * the temporal flagship: configs/kitti-planeseg.json's
                    modules minus the host visualizations, unedited, for 65
                    synthetic frames through the registry and the run loop
                    (K1 x65, K2 x65, K4 x65, K3 once per launch of its
                    fused sweeps: launches(24) on frames 1 and 64,
                    launches(8) on the others; no plain call);
                  * the non-temporal slice (no optflow, no temporal vote) for
                    10 frames;
                  * the reference-faithful flagship (the flagship's modules
                    with 'phase' statistics, 2 relax phases and the faithful
                    temporal vote) for 65 frames (K1 x65, K4 x65, K3 and K2
                    once per sub-step: launches(24, 2, 'phase') on frames 1
                    and 64, launches(8, 2, 'phase') on the others);
                  * configs/kitti-naive-segmentation-temporal.json minus its
                    visualization, in both temporal modes, 10 frames (K1
                    only);
                  * the flagship on grayscale frames for 10 frames (K3's
                    generic instantiation);
                  * the spatial mode: configs/kitti-planeseg-spatial.json
                    through read_config (8 row shards, on this one card) for
                    10 frames, every output equal frame by frame to the
                    full-frame pipeline of the same modules with the 'select'
                    warp (K5 x80 with 140 settle sweeps, K2 x80, K3
                    x(launches(24) + 9 launches(8)) x 8, K4 x80, K1 0, no
                    plain call), and the same with 'phase' statistics for 4
                    frames.
  4b. system - one warm eager flagship step under
                torch.cuda.set_sync_debug_mode("error"); then the temporal
                flagship and the faithful flagship (65 frames each) through
                the System (build_system, the CLI's host loop) at
                max_in_flight=4: with the captured step (a CUDA graph per
                variant, replayed) and with module_timing (the eager step),
                every key of the step fetched, every output of every frame
                and the final state equal (NaN equal to NaN), the replayed
                launches equal to the plan with no plain call; and a
                captured run fetching the host keys only.  Per-frame
                medians (CUDA events between frame ends), the graphs with
                their capture seconds, peak device memory.  The replayed
                flagship's launches are the kernels line's.
  4c. paths of the plane fits, the features and the ZED recording, 10
                frames each through the System on the card (build_system,
                captured step):
                  * configs/modules/kitti-planefit.json and
                    kitti-planecluster.json at 376x1248 (K1, K2, K3: 24 then
                    12 sweeps): planes_eq on every frame; frame 3's equal to
                    the port's on the CPU from the same fetched arrays and to
                    a second card run; the planecluster's native route taken
                    and equal to its Python route; K2 and K3 equal to their
                    plain versions on frame 1's inputs; the host module's process
                    ms and the share of its device span (its own stream) that
                    overlaps a replay;
                  * configs/kitti-features.json at 376x1248: captured equal
                    to eager (module_timing) on every output, a warm step
                    under set_sync_debug_mode("error"), level-0 keypoints
                    equal to the CPU port's, levels 1-2 and the descriptor
                    bits within a stated share;
                  * a 720x1280 ZED npz recording written from synthetic frames
                    and an SDK-style measure: configs/zed-disparity.json
                    (card == CPU port), the top-level configs/zed-planeseg.json
                    (SGM, K1-K4) and configs/modules/zed-planeseg.json
                    (zed_disparity, K2-K4), captured equal to eager on every
                    output of every frame; K2, K3 and K4 equal to their plain
                    versions on frame 1's inputs of each planeseg (about
                    6,400 and 3,600 labels); K1 at 720x1280 equal to its
                    plain version.
                Their K1-K4 launches join the flagship's in the kernels line
                (launches_by_path).
  4d. multiseq - the multi-sequence modes (multiseq_phase): 8 synthetic
                sequences (seeds 0-7) of the flagship for 65 rounds through the
                MultiSeqSystem, the captured batch (one graph a variant, each
                sequence on its own stream) equal to the eager batched step on
                every output of every sequence and round and the final state,
                K1-K4 8 x the flagship's plan; with a static provider, each
                sequence of the batch equal to the single-sequence System on
                its source (12 rounds); configs/synthetic-multiseq.json on the
                card equal to the CPU port (10 rounds); the composed mode
                (8 devices, 2 sequences: 4 shards each) for 10 rounds,
                captured (one graph a variant holding both sequences' shard
                threads' steps, each sequence on its own stream, K5's side
                streams shared) equal to its eager run and to the full-frame
                MultiSeqSystem on every output of every round, with K2, K3
                and K4 equal to their plain versions on their first calls'
                inputs on each shard, and its ms a round captured and eager,
                and with K5's side streams per sequence; the ms
                a round, frames/s against the
                single-sequence System, replay spans, peak memory, capture
                seconds and a profile of rounds 3..12.  Their K1-K5 launches
                join the kernels line ("multiseq (B=8)", "composed").
  4e. spatial system - configs/kitti-planeseg-spatial.json through
                build_system (8 row shards on this one card, histogram-peak
                provider, 4 in flight) for 66 frames (frame 64 the reset):
                captured (3 graphs, SpatialPipeline.captured_step), every
                fetched output of every frame array_equal to the eager
                spatial System (module_timing) and to the captured full-frame
                System with the 'select' warp; each graph's launches those of
                an eager frame of its variant, the step bodies captured with
                the collector off; per-frame medians captured (host keys,
                every key) against eager, capture seconds, peak memory, a
                profile of frames 3..12 captured and eager.  Its K2-K5
                launches join the kernels line ("spatial System").
  4f. multicard - the multi-card and multi-host modes (multicard_phase), at
                the flagship's width: (a) the MultiSeqSystem (8 sequences)
                with devices [cuda:0, cuda:0], two partitions with two
                graphs a variant, equal on every fetched output of 10 rounds
                and the final state to one partition; (b) two processes on
                this card (``chip_smoke.py --multihost-child``), each its
                4 sequences through read_system_config with a "multihost"
                block (gloo on localhost), equal to the one-process run for
                the same global sequences, the provider's ranges equal on
                both; the CLI as two processes, each exiting 0; (c) the
                spatial System with a stream per shard (event joins),
                captured, equal to the shared-stream run and the full frame,
                K2-K4 against their plain versions on its shards' inputs;
                (d) with two or more cards the spatial System across them
                (eager), the MultiSeqSystem over them and the width
                stencils across them, equal to the one-card runs, else a
                line that they did not run (``chip_smoke.py --cross-card``
                runs (d) alone on such a machine); (e) the
                width-sharded stencils on 8 shards array_equal to the
                unsharded ops; (f) the SpatialFlagship preset's captured
                steps over 4 frames equal to the config-built
                SpatialPipeline.  Their launches join the kernels line.
  5. parity   - the small temporal slice (64x128, 6 frames) on the card and on
                the CPU, every output and the final state equal, and the same
                with the reference-faithful modes; the full-size flow of one
                frame pair, card against CPU.
  5b. quality - utils/quality against the synthetic truth: the full-size
                flagship's and spatial System's last frames scored and
                printed; tests/test_quality.py's gate (its floors and
                ceilings at its settings: 96x320, 32 disparities, 8 frames,
                'frame' statistics) on a captured System run.
  6. profile  - one fresh temporal flagship over frames 3..12 under
                torch.profiler: per-module CUDA-event spans, device busy time
                and idle share, device time by kernel name and K2's and K4's
                a frame; the same for the faithful flagship, and for a fresh
                spatial run over frames 3..6 with K5's kernels by name; and a
                captured System run of each flagship over frames 3..12.
  7. cli      - configs/synthetic-planeseg.json through the CLI entry point,
                then configs/sources/synthetic.json with
                configs/modules/kitti-planeseg.json for 30 frames, --timing
                and --save-samples: a timing CSV with the JAX columns and a
                PNG of both plane-segmentation visualizations at frame 30.
  8. times    - per-frame ms and each kernel's numbers.
The last two lines of standard output are the kernels JSON line and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import threading

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, D = 376, 1248, 256
FRAMES = 65
NONTEMPORAL_FRAMES = 10
SPATIAL_FRAMES = 10
SHARDS = 8  # configs/kitti-planeseg-spatial.json's parallel.devices
# K5's settle sweeps a frame: in round j of the n-1, shard j sweeps top-down
# and shard n-1-j bottom-up, one launch each (SHARDS is even).
SETTLE_LAUNCHES = 2 * (SHARDS - 1)
K5_PROFILE_RUNS = 5  # profiled runs (and graph replays) of the 8 shards' K5
K5_REPLAYS = 20  # timed replays of the CUDA graph of one run of the 8 shards' K5
# K3 labels could differ from the plain version's only where torch's CUDA log
# and the kernel's logf round one value differently and so flip a strict-<
# tie.  Both call the same logf, and every run so far showed 0, so the bound
# is 0: a run that shows a flip is the case to record before loosening it.
RELAX_LABEL_BOUND = 0
# Frames of the profiled run (normal variant, no provider update, no reset).
PROFILE_FRAMES = (3, 12)
SPATIAL_PROFILE_FRAMES = (3, 6)
# Widths of the label tally: the rows [1, d, d^2] of a 9-channel init_stats
# (its path), and the 50 columns of the JAX package's byte-plane moment tally.
LABEL_TALLY_WIDTHS = (19, 50)

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): device
# memory 3.35 TB/s; 67 T float32 operations/s outside the tensor cores.  The
# data sheet gives no integer CUDA-core rate; the int32 rate is at most the
# float32 one, so using it for integer work keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# Operations per (pixel, disparity) cell of the SGM kernels: the census cost
# (2 xor, 2 popc, 1 add), 7 per path step (3 adds, 3 mins, 1 subtract) for 4
# paths, 3 adds for the 4-path sum; K1 adds 6 for its winner searches (keyed
# minimum, second minimum, right-view minimum).  K5 adds the settle sweeps
# the split scan needs: the cost and one path step in each of the 2 vertical
# directions per cell, on (n-1)/n of the frame (in each round only the shard
# whose carry in is already exact hands on a carry that is used).
SGM_AGGREGATE_OPS_PER_CELL = 5 + 4 * 7 + 3
SGM_FUSED_OPS_PER_CELL = SGM_AGGREGATE_OPS_PER_CELL + 6
SGM_SETTLE_OPS_PER_CELL = 2 * (5 + 7)
# Operations of one cost term of a relax call, per channel: a divide, a log,
# the variance and their adds, about 10.  K3's bound counts, once a call, one
# term per label (the prologue's c(label)); in every sweep, per boundary
# pixel, one c(old - pixel) term and one c(cand + pixel) term per distinct
# candidate label other than its own (the own label's delta is 0, and
# c(old), c(cand) are the prologue's), and per distinct candidate the
# clique's 8 compares and 8 adds.
RELAX_OPS_PER_TERM_CHANNEL = 10
RELAX_CLIQUE_OPS = 2 * 8
# Sweeps a launch of the fused relax kernel, timed against each other, with
# one phase and with two (a launch's halo is its sub-steps: 24 x 2 does not
# fit a block's shared memory).
RELAX_SWEEPS_PER_LAUNCH = (1, 2, 4, 8, 12, 24)
RELAX_SWEEPS_PER_LAUNCH_2PH = (1, 2, 4, 8, 12)
# Frames of the reference-faithful flagship's companions: the pixel plane
# segmentation (each temporal mode), the spatial 'phase'-stats run and the
# grayscale flagship.
PIXEL_FRAMES = 10
SPATIAL_PHASE_FRAMES = 4
GRAY_FRAMES = 10
# The spatial System: 66 frames, so that frame 64 (the reset) and a normal
# frame after it run; frames 3..65 give the medians.
SPATIAL_SYSTEM_FRAMES = 66
# tests/test_quality.py's floors and ceilings at its settings
# (scripts/eval_quality.evaluate with 'frame' statistics: 96x320, 32
# disparities, 8 frames, a static provider), copied: this script imports no
# test and nothing of the JAX package.
QUALITY_FLOORS = {"boundary_recall": 0.70, "plane_accuracy": 0.90, "disp_valid_frac": 0.92}
QUALITY_CEILINGS = {"underseg_error": 0.12, "flow_epe_px": 0.3, "disp_med_err_px": 0.3}
QUALITY_SIZE, QUALITY_D, QUALITY_FRAMES = (96, 320), 32, 8

# name -> (source, the TPU kernel it replaces (file:line), the path that runs it)
KERNELS = {
    "sgm": ("cartslam_tpu_torch/csrc/sgm.cu", "cartslam_tpu/ops/pallas/sgm.py:654",
            "the System paths"),
    "moment_tally": ("cartslam_tpu_torch/csrc/tally.cu", "cartslam_tpu/ops/pallas/tally.py:231",
                     "the System paths"),
    "relax": ("cartslam_tpu_torch/csrc/relax.cu", "cartslam_tpu/ops/pallas/relax.py:240",
              "the System paths"),
    "vote_tally": ("cartslam_tpu_torch/csrc/tally.cu", "cartslam_tpu/ops/pallas/tally.py:102",
                   "the System paths"),
    "sgm_aggregate": ("cartslam_tpu_torch/csrc/sgm.cu", "cartslam_tpu/ops/pallas/sgm.py:510",
                      "sgm_aggregate entry point"),
    "label_tally": ("cartslam_tpu_torch/csrc/tally.cu", "cartslam_tpu/ops/pallas/tally.py:318",
                    "init_stats entry point, 9 channels"),
    "sgm_sharded": ("cartslam_tpu_torch/csrc/sgm.cu", "cartslam_tpu/ops/pallas/sgm.py:320",
                    "spatial mode, 8 shards on one card"),
}


def launch_plan() -> dict:
    """The launches each path must count, by kernel.  The superpixels run 24
    sweeps on frame 1 and on the reset frame 64, 8 on the others, and K3
    launches kernels/relax.launches(sweeps, phases, stats_refresh) times per
    call.  Every kernel launch of the spatial mode is per shard."""
    from cartslam_tpu_torch.kernels.relax import launches

    def k3(frames, resets=0, phases=1, stats_refresh="frame"):
        return ((1 + resets) * launches(24, phases, stats_refresh)
                + (frames - 1 - resets) * launches(8, phases, stats_refresh))

    # 'phase' statistics: one K3 launch a sub-step, and one K2 tally before
    # each (the call's first, then a re-tally after every sub-step but the
    # last), so K2 counts what K3 counts.
    faithful = k3(FRAMES, 1, 2, "phase")
    spatial_phase = k3(SPATIAL_PHASE_FRAMES, 0, 1, "phase")
    return {
        "faithful": {"sgm": FRAMES, "moment_tally": faithful, "relax": faithful,
                     "vote_tally": FRAMES},
        "pixel": {"sgm": PIXEL_FRAMES, "moment_tally": 0, "relax": 0, "vote_tally": 0},
        "grayscale": {"sgm": GRAY_FRAMES, "moment_tally": GRAY_FRAMES, "relax": k3(GRAY_FRAMES),
                      "vote_tally": GRAY_FRAMES},
        "spatial_phase_full": {"sgm": SPATIAL_PHASE_FRAMES, "sgm_sharded": 0, "sgm_settle": 0,
                               "moment_tally": spatial_phase, "relax": spatial_phase,
                               "vote_tally": SPATIAL_PHASE_FRAMES},
        "spatial_phase": {"sgm": 0, "sgm_sharded": SHARDS * SPATIAL_PHASE_FRAMES,
                          "sgm_settle": SETTLE_LAUNCHES * SPATIAL_PHASE_FRAMES,
                          "moment_tally": SHARDS * spatial_phase,
                          "relax": SHARDS * spatial_phase,
                          "vote_tally": SHARDS * SPATIAL_PHASE_FRAMES},
        "flagship": {"sgm": FRAMES, "moment_tally": FRAMES, "relax": k3(FRAMES, 1),
                     "vote_tally": FRAMES},
        "nontemporal": {"sgm": NONTEMPORAL_FRAMES, "moment_tally": NONTEMPORAL_FRAMES,
                        "relax": k3(NONTEMPORAL_FRAMES), "vote_tally": NONTEMPORAL_FRAMES},
        "full_frame_select": {"sgm": SPATIAL_FRAMES, "sgm_sharded": 0, "sgm_settle": 0,
                              "moment_tally": SPATIAL_FRAMES, "relax": k3(SPATIAL_FRAMES),
                              "vote_tally": SPATIAL_FRAMES},
        "spatial": {"sgm": 0, "sgm_sharded": SHARDS * SPATIAL_FRAMES,
                    "sgm_settle": SETTLE_LAUNCHES * SPATIAL_FRAMES,
                    "moment_tally": SHARDS * SPATIAL_FRAMES,
                    "relax": SHARDS * k3(SPATIAL_FRAMES), "vote_tally": SHARDS * SPATIAL_FRAMES},
        "spatial_system": {"sgm": 0, "sgm_sharded": SHARDS * SPATIAL_SYSTEM_FRAMES,
                           "sgm_settle": SETTLE_LAUNCHES * SPATIAL_SYSTEM_FRAMES,
                           "moment_tally": SHARDS * SPATIAL_SYSTEM_FRAMES,
                           "relax": SHARDS * k3(SPATIAL_SYSTEM_FRAMES, 1),
                           "vote_tally": SHARDS * SPATIAL_SYSTEM_FRAMES},
        "spatial_system_full": {"sgm": SPATIAL_SYSTEM_FRAMES, "sgm_sharded": 0, "sgm_settle": 0,
                                "moment_tally": SPATIAL_SYSTEM_FRAMES,
                                "relax": k3(SPATIAL_SYSTEM_FRAMES, 1),
                                "vote_tally": SPATIAL_SYSTEM_FRAMES},
    }


class OpCount(TorchDispatchMode):
    """Counts the ATen ops a block dispatches (views included): the host
    work of an eager, launch-bound function."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


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


def graph_ms(fn, calls: int = 100, replays: int = 3) -> float:
    """Device ms a call of fn: CUDA events around replays of a CUDA graph of
    `calls` captured calls, after a warm-up call and a warm-up replay.  The
    host's work in fn (a wrapper's checks, allocations, the ctypes call) is
    not in the graph, only what it enqueued."""
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


def timed_once(fn):
    """(result, ms) of one call, from CUDA events (no warm-up)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def relax_work(lab: torch.Tensor, phase: int = 0, num_phases: int = 1) -> tuple[int, int]:
    """(boundary pixels of parity `phase`, distinct candidate labels (not
    -1) summed over them) of lab: the pixels a relax sub-step from lab must
    score, and their candidates, each pixel's own label among them."""
    from cartslam_tpu_torch.kernels.relax import phase_mask

    h, w = lab.shape
    pad = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=-1)
    nbs = [pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    boundary = torch.zeros((h, w), dtype=torch.bool, device=lab.device)
    for j, nb in enumerate(nbs):
        if j != 4:
            boundary |= (nb != -1) & (nb != lab)
    count = torch.zeros((h, w), dtype=torch.int32, device=lab.device)
    for j, nb in enumerate(nbs):
        new = nb != -1
        for nb2 in nbs[:j]:
            new &= nb != nb2
        count += new.int()
    active = boundary & (lab != -1) & phase_mask(h, w, phase, num_phases, 0, lab.device)
    return int(active.sum()), int(count[active].sum())


def flagship_modules() -> list[dict]:
    """configs/kitti-planeseg.json's modules, minus the host visualizations,
    as written (optflow, use_temporal_smoothing: true)."""
    with open(os.path.join(REPO, "configs", "kitti-planeseg.json")) as f:
        mods = json.load(f)["modules"]
    return [m for m in mods if not m["type"].endswith("_visualization")]


def faithful_modules() -> list[dict]:
    """The reference-faithful flagship: the flagship's modules with 'phase'
    statistics and two relax phases in the superpixels and the faithful
    (K-gather) temporal vote."""
    out = []
    for m in flagship_modules():
        if m["type"] == "superpixels":
            m = {**m, "stats_refresh": "phase", "relax_phases": 2}
        elif m["type"] == "superpixel_disparity_planeseg":
            m = {**m, "temporal_mode": "faithful"}
        out.append(m)
    return out


def pixel_modules(temporal_mode: str) -> list[dict]:
    """configs/kitti-naive-segmentation-temporal.json's modules minus the
    host visualization, with the pixel plane segmentation's temporal mode."""
    with open(os.path.join(REPO, "configs", "kitti-naive-segmentation-temporal.json")) as f:
        mods = json.load(f)["modules"]
    return [{**m, "temporal_mode": temporal_mode} if m["type"] == "disparity_planeseg" else m
            for m in mods if not m["type"].endswith("_visualization")]


def nontemporal_modules() -> list[dict]:
    """The flagship without its temporal branch (the first slice's path)."""
    out = []
    for m in flagship_modules():
        if m["type"] == "optflow":
            continue
        if m["type"] == "superpixel_disparity_planeseg":
            m = {**m, "use_temporal_smoothing": False}
        out.append(m)
    return out


def kernel_phase(dev, tag):
    """Each kernel vs its plain version at the flagship's shapes.  Returns
    {name: dict(max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by)}
    and the inputs the path phase reuses."""
    from cartslam_tpu_torch.kernels import build
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

    def record(name, err, ms, pms, lms, nbytes, ops):
        bms, by = bound(nbytes, ops)
        results[name] = dict(max_abs_err=float(err), ms=ms, plain_ms=pms, library_ms=lms,
                             bound_ms=bms, bound_by=by)

    # K1: the synthetic pair's census and uniform random 31-bit census
    # words (the census's range; many tied costs), at the flagship's shape,
    # at D=64, and on an odd crop at the uint8 storage's largest p2 and at
    # D=100, each with the LR check and the subpixel step on and off.
    gl, gr = color.bgr_to_gray(left), color.bgr_to_gray(right)
    cl = stereo.census_transform(gl)
    cr = stereo.census_transform(gr)
    gen = torch.Generator(device=dev).manual_seed(1)
    rand = [torch.randint(0, 2**31, (H, W), generator=gen, device=dev, dtype=torch.int32)
            for _ in range(4)]
    crop = lambda words: [x[:37, :61].contiguous() for x in words]
    flag = dict(min_disparity=4, num_disparities=D, p1=10, p2=120)
    d64 = dict(min_disparity=0, num_disparities=64, p1=10, p2=120)
    odd = dict(min_disparity=3, num_disparities=15, p1=7, p2=ksgm.MAX_P2)
    # D=100: two 16-bit pairs a lane, more disparities than the crop is wide.
    wide = dict(min_disparity=1, num_disparities=100, p1=10, p2=120)
    cases = [("synthetic", [*cl, *cr], flag), ("random", rand, flag),
             ("synthetic", [*cl, *cr], d64), ("random", rand, d64),
             ("synthetic [37,61]", crop([*cl, *cr]), odd), ("random [37,61]", crop(rand), odd),
             ("random [37,61]", crop(rand), wide)]
    for name, words, ckw in cases:
        valid = []
        for lr in (True, False):
            for sub in (True, False):
                kw = dict(ckw, uniqueness=12, subpixel=sub, lr_check=lr)
                a, b = ksgm.sgm_fused(*words, **kw), stereo.sgm_from_census_plain(*words, **kw)
                if not torch.equal(a, b):
                    raise AssertionError(f"K1 sgm, {name} census, {kw}: "
                                         f"{int((a != b).sum())} pixels differ from the plain "
                                         "version")
                valid.append(float((a != stereo.DISPARITY_INVALID).float().mean()))
        log(f"K1 sgm: array_equal on {name} census, D={ckw['num_disparities']} minD "
            f"{ckw['min_disparity']} p2 {ckw['p2']}, LR and subpixel on/off (valid share "
            f"{', '.join(f'{v:.3f}' for v in valid)})")
    kw = dict(flag, uniqueness=12, subpixel=True, lr_check=True)
    out_k = ksgm.sgm_fused(*cl, *cr, **kw)
    out_p = stereo.sgm_from_census_plain(*cl, *cr, **kw)
    ms = cuda_ms(lambda: ksgm.sgm_fused(*cl, *cr, **kw), 20)
    pms = cuda_ms(lambda: stereo.sgm_from_census_plain(*cl, *cr, **kw), 2)
    record("sgm", (out_k.int() - out_p.int()).abs().max(), ms, pms, None,
           4 * H * W * 4 + H * W * 2, H * W * D * SGM_FUSED_OPS_PER_CELL)
    # K1's two kernels alone, on the same inputs.
    lib, stream = build.library(), build.stream()
    vol = torch.empty((4, H, W, ksgm.padded_disparities(D)), dtype=torch.uint8, device=dev)
    out16 = torch.empty((H, W), dtype=torch.int16, device=dev)
    paths_ms = cuda_ms(lambda: build.check(lib.sgm_paths(
        *(x.data_ptr() for x in (*cl, *cr)), vol.data_ptr(), H, W, D, 4, 10, 120, stream),
        "sgm_paths"), 20)
    wta_ms = cuda_ms(lambda: build.check(lib.sgm_wta(
        vol.data_ptr(), out16.data_ptr(), H, W, D, 4, 12, 1, 1, stream), "sgm_wta"), 20)
    if not torch.equal(out16, out_k):
        raise AssertionError("K1: sgm_paths + sgm_wta called alone differ from sgm_fused")
    del vol
    log(f"K1 sgm: kernel {ms:.3f} ms (sgm_paths {paths_ms:.3f} ms, sgm_wta {wta_ms:.3f} ms "
        f"alone), plain {pms:.3f} ms at [{H},{W}] D={D}  [{tag}]")

    # K6, then the SGM stages side by side.
    akw = dict(min_disparity=4, num_disparities=D, p1=10, p2=120)
    agg_k = ksgm.sgm_aggregate(*cl, *cr, **akw)
    agg_p = ksgm.sgm_aggregate_plain(*cl, *cr, **akw)
    if agg_k.shape != (H, W, D) or not torch.equal(agg_k, agg_p):
        n = int((agg_k != agg_p).sum())
        raise AssertionError(f"K6 sgm_aggregate: {n} of {agg_p.numel()} cells differ")
    err = (agg_k.int() - agg_p.int()).abs().max()
    del agg_p, agg_k
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: ksgm.sgm_aggregate(*cl, *cr, **akw), 10)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    agg_k = ksgm.sgm_aggregate(*cl, *cr, **akw)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    del agg_k
    pms = cuda_ms(lambda: ksgm.sgm_aggregate_plain(*cl, *cr, **akw), 1)
    record("sgm_aggregate", err, ms, pms, None, 4 * H * W * 4 + H * W * D * 2,
           H * W * D * SGM_AGGREGATE_OPS_PER_CELL)
    log(f"K6 sgm_aggregate: array_equal int16 [{H},{W},{D}] (p1 10, p2 120, min 4); "
        f"kernel {ms:.4f} ms, plain {pms:.3f} ms; peak device memory of a call "
        f"{peak_mb:.1f} MiB (the output: {H * W * D * 2 / 2**20:.1f})  [{tag}]")
    torch.cuda.empty_cache()
    # The JAX op's whole p2 range (int16 sums; K1 stops at 193), at full size.
    big = dict(akw, p2=8000)
    hk = ksgm.sgm_aggregate(*cl, *cr, **big)
    hp = ksgm.sgm_aggregate_plain(*cl, *cr, **big)
    if not torch.equal(hk, hp) or int(hp.max()) <= 255:
        raise AssertionError("K6 sgm_aggregate at p2=8000 differs from its plain version")
    log(f"K6 sgm_aggregate at p2=8000: array_equal on [{H},{W},{D}], max {int(hp.max())}")
    del hk, hp
    torch.cuda.empty_cache()
    # Odd and even H and W (the midpoints of both passes: an odd W's middle
    # cell, an odd H's middle row), D not a multiple of a lane's run (masked
    # scalar stores) and each run length, on the synthetic and on uniform
    # random census words.
    k6_cases = [((37, 61), dict(min_disparity=3, num_disparities=15, p1=7, p2=86)),
                ((38, 60), dict(min_disparity=0, num_disparities=33, p1=10, p2=8000)),
                ((23, 64), dict(min_disparity=2, num_disparities=64, p1=10, p2=120)),
                ((40, 101), dict(min_disparity=1, num_disparities=100, p1=10, p2=120)),
                ((16, 44), dict(min_disparity=2, num_disparities=8, p1=7, p2=86)),
                ((1, 61), dict(min_disparity=0, num_disparities=50, p1=10, p2=120)),
                ((9, 1), dict(min_disparity=0, num_disparities=16, p1=10, p2=120))]
    for (h, w), ckw in k6_cases:
        for name, words in (("synthetic", (*cl, *cr)), ("random", rand)):
            part = [x[:h, :w].contiguous() for x in words]
            if not torch.equal(ksgm.sgm_aggregate(*part, **ckw),
                               ksgm.sgm_aggregate_plain(*part, **ckw)):
                raise AssertionError(f"K6 sgm_aggregate on {name} [{h},{w}], {ckw} differs "
                                     "from its plain version")
    log("K6 sgm_aggregate array_equal on synthetic and random census at "
        + "; ".join(f"[{h},{w}] D={c['num_disparities']} p2 {c['p2']}" for (h, w), c in k6_cases))
    census_ms = cuda_ms(lambda: (stereo.census_transform(gl), stereo.census_transform(gr)), 10)
    log(f"SGM stages at [{H},{W}] D={D}: census x2 {census_ms:.3f} ms, "
        f"K6 aggregate {results['sgm_aggregate']['ms']:.3f} ms, "
        f"K1 fused aggregate+WTA {results['sgm']['ms']:.3f} ms  [{tag}]")
    torch.cuda.empty_cache()

    # Inputs of K2..K4 and K7 as the flagship builds them.
    disp = disparity.interpolate(out_k, radius=2, iterations=1, min_disparity=64, max_disparity=W)
    deriv, _ = derivative.directional_derivatives(disp)
    img = color.bgr_to_ycrcb(left).to(torch.float32)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    data = torch.cat([deriv.permute(2, 0, 1).float(), img.permute(2, 0, 1),
                      torch.stack([xs, ys]).float()]).contiguous()
    labels, max_label = sp.block_init_labels(H, W, 12, 12, dev)
    num_labels = max_label + 1
    flat = labels.reshape(-1).contiguous()
    n = flat.numel()
    # K2 and K4 take the image's layout (their tiles are 2-D); the plain
    # versions the flat arrays.
    data_i = data.to(torch.int32)
    data_flat = data_i.reshape(7, -1)

    # K2 (held on hard layouts and timed in tally_phase, below)
    tk = ktally.moment_tally(labels, data_i, num_labels)
    if not torch.equal(tk, ktally.moment_tally_plain(flat, data_flat, num_labels)):
        raise AssertionError("K2 moment tally differs from the plain version on the block grid")

    # K3: a call's fused sweeps against relax_sweeps_plain, labels and stat
    # image, from the block grid and from the labels after 24 sweeps (where
    # the boundary is the flagship's after frame 1).
    feats = [krelax.RelaxFeature("gaussian", 0, 2, 1.0), krelax.RelaxFeature("gaussian", 2, 3, 1.5),
             krelax.RelaxFeature("compactness", 5, 2, 0.1)]
    diag = 0.5 / np.sqrt(2)
    k3 = lambda lab, n, table, **kw: krelax.relax_sweeps(lab, table, data, feats, 7, n, 0.5,
                                                         diag, **kw)
    p3 = lambda lab, n, table: krelax.relax_sweeps_plain(lab, table, data, feats, 7, n, 0.5,
                                                         diag, return_stats=True)
    # From the block grid with its table (frame 1's call), and from the
    # labels after those 24 sweeps with their own table (the next frame's).
    labels24 = k3(labels, 24, table=tk)
    tk24 = ktally.moment_tally(labels24, data_i, num_labels)
    for start_name, start, table in (("the block grid", labels, tk),
                                     ("the labels after 24 sweeps", labels24, tk24)):
        if int((k3(start, 1, table=table) != start).sum()) == 0:
            raise AssertionError(f"K3 relax: a sweep from {start_name} moved no label")
        for n_sweeps in (1, 8, 24):
            lk, sk = k3(start, n_sweeps, table=table, return_stats=True)
            lp, spl = p3(start, n_sweeps, table)
            ndiff, moved = int((lk != lp).sum()), int((lk != start).sum())
            log(f"K3 relax, {n_sweeps} sweeps from {start_name}: {ndiff} label pixels differ "
                f"from the plain version (bound {RELAX_LABEL_BOUND}); {moved} pixels differ "
                "from the start")
            if ndiff > RELAX_LABEL_BOUND:
                raise AssertionError("K3 relax disagrees with its plain version")
            if not torch.equal(sk, spl):
                raise AssertionError("K3 relax: the stat image differs from the plain version's")
    ms = cuda_ms(lambda: k3(labels24, 8, table=tk24), 50)
    pms = cuda_ms(lambda: krelax.relax_sweeps_plain(labels24, tk24, data, feats, 7, 8, 0.5,
                                                    diag), 2)
    # The same calls split into launches of 1-24 sweeps, through the C entry
    # points (the wrapper's split is krelax.SWEEPS_PER_LAUNCH, chosen from
    # these times); each split gives the wrapper's labels.
    nf, num, cfeats = len(feats), tk.shape[-1], krelax.c_features(feats)
    rows = torch.empty((num + 1, krelax.ROW_STRIDE), dtype=torch.float32, device=dev)
    bufs = (torch.empty_like(labels), torch.empty_like(labels))

    def k3_split(start, table, iterations, per_launch, phases=1):
        build.check(lib.relax_label_rows(table.data_ptr(), rows.data_ptr(), num, 7, nf,
                                         *cfeats, stream), "relax_label_rows")
        cur = start
        for done in range(0, iterations, per_launch):
            out = bufs[done // per_launch % 2]
            steps = min(per_launch, iterations - done) * phases
            build.check(lib.relax_sweeps(cur.data_ptr(), data.data_ptr(), rows.data_ptr(),
                                         out.data_ptr(), H, W, num, 7, nf, *cfeats, None, 0.5,
                                         diag, steps, 0, phases, 0, stream), "relax_sweeps")
            cur = out
        return cur

    per_launch = {}
    for phases, splits in ((1, RELAX_SWEEPS_PER_LAUNCH), (2, RELAX_SWEEPS_PER_LAUNCH_2PH)):
        for k in splits:
            for start, table, iterations in ((labels24, tk24, 8), (labels, tk, 24)):
                if not torch.equal(k3_split(start, table, iterations, k, phases),
                                   k3(start, iterations, table=table, phases=phases)):
                    raise AssertionError(f"K3 relax: {iterations} sweeps of {phases} phase(s) "
                                         f"in launches of {k} differ from the wrapper's")
            per_launch[phases, k] = (cuda_ms(lambda: k3_split(labels24, tk24, 8, k, phases), 30),
                                     cuda_ms(lambda: k3_split(labels, tk, 24, k, phases), 10))
    # Bound of the flagship frame's call (8 sweeps from labels24): the labels
    # in and out, the 7 data planes and the table, once; the prologue's term
    # per label, and every sweep's terms and cliques of its boundary pixels.
    lab, pixels, cands = labels24, 0, 0
    for _ in range(8):
        p, c = relax_work(lab)
        pixels, cands = pixels + p, cands + c
        lab = k3(lab, 1, table=tk24)
    term = 7 * RELAX_OPS_PER_TERM_CHANNEL
    record("relax", (lk - lp).abs().max(), ms, pms, None,
           2 * 4 * n + 7 * 4 * n + 4 * tk24.numel(),
           num * term + pixels * term + (cands - pixels) * term + cands * RELAX_CLIQUE_OPS)
    log(f"K3 relax: 8 sweeps from the labels after 24 (a flagship frame's call, "
        f"{krelax.launches(8)} launch(es)) kernel {ms:.3f} ms, plain {pms:.3f} ms; "
        f"{pixels} boundary pixels and {cands} distinct candidates over the 8 sweeps  [{tag}]")
    for phases in (1, 2):
        log(f"K3 relax, {phases} phase(s), ms by sweeps a launch (8-sweep call / 24-sweep call "
            "from the block grid; C entry points): "
            + ", ".join(f"{k}: {a:.4f} / {b:.4f}" for (ph, k), (a, b) in per_launch.items()
                        if ph == phases)
            + f"; the wrapper's {krelax.SWEEPS_PER_LAUNCH}  [{tag}]")
    # K4's votes: the plane classes of the derivative, as the flagship's.
    ranges = torch.tensor([[3, 40], [-6, 3]], dtype=torch.int32, device=dev)
    votes = planeseg.classify(deriv[..., 0], ranges).reshape(-1).contiguous()
    t = dict(data=data, labels=labels, tk=tk, labels24=labels24, tk24=tk24, feats=feats,
             gray=gl, deriv=deriv, num_labels=num_labels, votes=votes)
    relax_phase_checks(dev, tag, t)
    tally_phase(dev, tag, t, results)

    # The 9 channels of an init_stats that routes to K7: the 7 flagship
    # channels, gray and disparity.
    data9 = torch.cat([data, gl[None].float(), (disp.float() / 16).round()[None]])
    label_tally_phase(dev, tag, t, data9, results)
    paths = dict(census=(cl, cr), labels=labels, data9=data9, num_labels=num_labels,
                 k1_disparity=out_k, votes=votes, feats=feats)
    return results, paths


def relax_phase_checks(dev, tag, t) -> None:
    """K3's generic instantiation, its progressive factor and its phase
    argument, each against the plain version on the card at the flagship's
    size (3329 labels), RELAX_LABEL_BOUND differing labels at most:
      * the grayscale layout (derivative 2, gray 1, compactness 2: 5
        channels) and the flagship's layout with a progressive factor, 1, 8
        and 24 sweeps from the block grid;
      * two phases in 'frame' stats mode, 8 and 24 sweeps, from the block
        grid and from settled labels, in both instantiations;
      * a 'phase'-stats call, 24 sweeps x 2 phases from the block grid: one
        sub-step a launch, each from a fresh K2 table (the label-row
        prologue on each), against the same call through the plain versions;
      * shard 0's rows with a 16-row halo above the frame (row0 = -16), two
        phases, against the plain version and the full frame's rows;
    and times a 'phase'-mode launch (one sub-step from a fresh table, its
    label-row prologue included) and a 'phase'-mode frame's call (8 sweeps x
    2 phases with their re-tallies)."""
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.kernels import relax as krelax
    from cartslam_tpu_torch.kernels import tally as ktally

    data, labels, tk, labels24, tk24, feats = (t[k] for k in ("data", "labels", "tk", "labels24",
                                                               "tk24", "feats"))
    num, n, diag = t["num_labels"], H * W, 0.5 / np.sqrt(2)
    rf = krelax.RelaxFeature
    data5 = torch.cat([t["deriv"].permute(2, 0, 1).float(), t["gray"][None].float(),
                       data[5:7]]).contiguous()
    feats5 = [rf("gaussian", 0, 2, 1.0), rf("gaussian", 2, 1, 1.5), rf("compactness", 3, 2, 0.1)]

    def table_of(lab, d):
        return ktally.moment_tally(lab, d.to(torch.int32), num)

    tk5 = table_of(labels, data5)
    gh = torch.tensor(float(H), device=dev)
    prog = (1.0 + 0.5 * (gh - torch.arange(H, dtype=torch.float32, device=dev)) / gh)
    # name -> (data, features, channels, table from the block grid, prog)
    layouts = {"grayscale": (data5, feats5, 5, tk5, None),
               "flagship": (data, feats, 7, tk, None),
               "flagship + progressive": (data, feats, 7, tk, prog.contiguous())}

    def compare(what, lk, lp, start):
        ndiff = int((lk != lp).sum())
        moved = int(((lk != start) & (start >= 0)).sum())
        log(f"K3 {what}: {ndiff} label pixels differ from the plain version (bound "
            f"{RELAX_LABEL_BOUND}); {moved} pixels moved")
        if ndiff > RELAX_LABEL_BOUND or moved == 0:
            raise AssertionError(f"K3 {what}: disagrees with its plain version, or moved nothing")

    for name in ("grayscale", "flagship + progressive"):
        d, f, c, table, pr = layouts[name]
        inst = krelax.instantiation(f, c)
        for sweeps in (1, 8, 24):
            compare(f"{name} layout ({c} channels, {inst}), {sweeps} sweeps from the block grid",
                    krelax.relax_sweeps(labels, table, d, f, c, sweeps, 0.5, diag, pr),
                    krelax.relax_sweeps_plain(labels, table, d, f, c, sweeps, 0.5, diag, pr),
                    labels)
    for name in ("flagship", "grayscale"):
        d, f, c, table, _ = layouts[name]
        inst = krelax.instantiation(f, c)
        settled = labels24 if c == 7 else krelax.relax_sweeps(labels, table, d, f, c, 24, 0.5,
                                                              diag)
        settled_table = tk24 if c == 7 else table_of(settled, d)
        for start_name, start, tb in (("the block grid", labels, table),
                                      ("the labels after 24 sweeps", settled, settled_table)):
            for sweeps in (8, 24):
                compare(f"{name} layout ({inst}), 2 phases, {sweeps} sweeps from {start_name}",
                        krelax.relax_sweeps(start, tb, d, f, c, sweeps, 0.5, diag, phases=2),
                        krelax.relax_sweeps_plain(start, tb, d, f, c, sweeps, 0.5, diag,
                                                  phases=2),
                        start)

    def phase_call(kernel: bool, start, sweeps):
        step = krelax.relax_phase if kernel else krelax.relax_phase_plain
        lab, d_i = start, data.to(torch.int32)
        for k in range(sweeps * 2):
            table = (ktally.moment_tally(lab, d_i, num) if kernel else
                     ktally.moment_tally_plain(lab.reshape(-1), d_i.reshape(7, -1), num))
            lab = step(lab, table, data, feats, 7, k % 2, 2, 0.5, diag)
        return lab

    build.reset_counts()
    lk = phase_call(True, labels, 24)
    torch.cuda.synchronize()
    counts = (build.COUNTERS["relax"].launches, build.COUNTERS["moment_tally"].launches)
    if counts != (48, 48):
        raise AssertionError(f"K3 'phase' call: (relax, moment_tally) launches {counts}, "
                             "expected (48, 48)")
    compare(f"'phase' stats, 24 sweeps x 2 phases from the block grid ({counts[0]} launches, "
            f"{counts[1]} K2 tallies)", lk, phase_call(False, labels, 24), labels)
    # The faithful flagship's labels after a frame's first 8 sub-steps, for
    # K2's and K4's checks.
    t["labels8"] = phase_call(True, labels, 4)

    halo, hl = 16, H // SHARDS  # 8 sweeps x 2 phases on shard 0, rows -16 .. hl + 15
    rows = torch.arange(-halo, hl + halo, device=dev)
    inside = rows >= 0
    src = rows.clamp(0, H - 1)
    lab_ext = torch.where(inside[:, None], labels[src], -1).contiguous()
    data_ext = data[:, src].contiguous()
    lk = krelax.relax_sweeps(lab_ext, tk, data_ext, feats, 7, 8, 0.5, diag, phases=2, row0=-halo)
    compare("shard 0 with a 16-row halo above the frame (row0 -16), 2 phases, 8 sweeps", lk,
            krelax.relax_sweeps_plain(lab_ext, tk, data_ext, feats, 7, 8, 0.5, diag, phases=2,
                                      row0=-halo), lab_ext)
    full = krelax.relax_sweeps(labels, tk, data, feats, 7, 8, 0.5, diag, phases=2)
    if not (torch.equal(lk[halo:halo + hl], full[:hl]) and bool((lk[:halo] == -1).all())):
        raise AssertionError("K3 row0 < 0: shard 0's rows differ from the full frame's")
    for phase in (0, 1):
        compare(f"one 'phase' sub-step of parity {phase} on shard 0 (row0 -16)",
                krelax.relax_phase(lab_ext, tk, data_ext, feats, 7, phase, 2, 0.5, diag,
                                   row0=-halo),
                krelax.relax_phase_plain(lab_ext, tk, data_ext, feats, 7, phase, 2, 0.5, diag,
                                         row0=-halo), lab_ext)

    # The wrapper's call costs more host time than the launch takes on the
    # card, so the kernel's time comes from its C entry points in a loop (the
    # label-row prologue and one sub-step); the wrapper's is printed beside.
    lib, stream = build.library(), build.stream()
    nf, cf = len(feats), krelax.c_features(feats)
    rows = torch.empty((num + 1, krelax.ROW_STRIDE), dtype=torch.float32, device=dev)
    out = torch.empty_like(labels24)

    def c_launch():
        build.check(lib.relax_label_rows(tk24.data_ptr(), rows.data_ptr(), num, 7, nf, *cf,
                                         stream), "relax_label_rows")
        build.check(lib.relax_sweeps(labels24.data_ptr(), data.data_ptr(), rows.data_ptr(),
                                     out.data_ptr(), H, W, num, 7, nf, *cf, None, 0.5, diag, 1,
                                     0, 2, 0, stream), "relax_sweeps")

    c_launch()
    want = krelax.relax_phase(labels24, tk24, data, feats, 7, 0, 2, 0.5, diag)
    if not torch.equal(out, want):
        raise AssertionError("K3: the C entry points' sub-step differs from the wrapper's")
    ms = cuda_ms(c_launch, 200)
    wrapper_ms = cuda_ms(lambda: krelax.relax_phase(labels24, tk24, data, feats, 7, 0, 2, 0.5,
                                                    diag), 50)
    pms = cuda_ms(lambda: krelax.relax_phase_plain(labels24, tk24, data, feats, 7, 0, 2, 0.5,
                                                   diag), 3)
    pixels, cands = relax_work(labels24, 0, 2)
    term = 7 * RELAX_OPS_PER_TERM_CHANNEL
    bms, by = bound(2 * 4 * n + 7 * 4 * n + 4 * tk24.numel(),
                    num * term + pixels * term + (cands - pixels) * term
                    + cands * RELAX_CLIQUE_OPS)
    frame_ms = cuda_ms(lambda: phase_call(True, labels24, 8), 10)
    log(f"K3 'phase'-mode launch (one sub-step of parity 0 from the labels after 24 sweeps, "
        f"{pixels} active pixels, {cands} distinct candidates; label-row prologue included): "
        f"kernel {ms:.4f} ms (C entry points; {wrapper_ms:.4f} ms through the wrapper), plain "
        f"{pms:.4f} ms, bound {bms:.4f} ms ({by}); a 'phase'-mode "
        f"frame's call (8 sweeps x 2 phases: 16 launches and 16 K2 tallies) {frame_ms:.4f} ms"
        f"  [{tag}]")


def tally_phase(dev, tag, t, results) -> None:
    """K2 and K4 against their plain versions, array_equal, on the
    flagship's inputs and on hard layouts:
      * the block grid (K2), the labels after 24 sweeps, and the faithful
        flagship's labels after a frame's first 8 sub-steps;
      * random labels over [-2, L + 2) with random data over K2's whole
        domain (a tile holds more labels than slots: the device-memory
        route), random votes over [0, P] (P drops);
      * one label everywhere (every pixel on one slot);
      * every label dropped (-1 and L), every vote P;
      * a flat N that is not a multiple of the tile nor of 4 (one 47-row
        shard plus 37 pixels) from the second pixel on (unaligned rows:
        masked scalar loads);
      * every channel at -32768, and at 32767 (K2);
      * the psum path: the tables of the frame's two halves summed (K2's
        int64 tables, then rounded once) against the full frame's.
    Then times, at the flagship's shapes (the labels after 24 sweeps), each
    kernel's device ms a call (CUDA events around the replay of a CUDA graph
    of 100 captured wrapper calls: the wrapper's host work, longer than these
    kernels, is left out), its wrapper ms (`cuda_ms`), its plain and library
    ms, and records K2 and K4."""
    from cartslam_tpu_torch.kernels import tally as ktally

    labels, labels24, labels8 = t["labels"], t["labels24"], t["labels8"]
    num, n = t["num_labels"], H * W
    data_i = t["data"].to(torch.int32)
    votes = t["votes"].reshape(H, W)
    gen = torch.Generator(device=dev).manual_seed(7)
    rand_labels = torch.randint(-2, num + 2, (H, W), generator=gen, device=dev,
                                dtype=torch.int32)
    rand_data = torch.randint(ktally.DATA_MIN, ktally.DATA_MAX + 1, (7, H, W), generator=gen,
                              device=dev, dtype=torch.int32)
    rand_votes = torch.randint(0, 4, (H, W), generator=gen, device=dev, dtype=torch.uint8)
    one = torch.full_like(labels, num // 2)
    dropped = torch.where(labels24 % 2 == 0, -1, num).to(torch.int32)
    ragged = slice(1, 1 + H // SHARDS * W + 37)
    ragged_name = (f"a flat N = {H // SHARDS * W + 37} ({H // SHARDS} rows + 37 pixels) from "
                   "pixel 1")
    moment_layouts = {
        "the block grid": (labels, data_i),
        "the labels after 24 sweeps": (labels24, data_i),
        "the faithful flagship's labels after 8 sub-steps": (labels8, data_i),
        "random labels over [-2, L+2), random data over the domain": (rand_labels, rand_data),
        "one label everywhere": (one, data_i),
        "every label dropped": (dropped, data_i),
        ragged_name: (labels24.reshape(-1)[ragged], data_i.reshape(7, -1)[:, ragged]),
        "every channel at -32768": (labels24, torch.full_like(data_i, ktally.DATA_MIN)),
        "every channel at 32767": (labels24, torch.full_like(data_i, ktally.DATA_MAX)),
    }
    vote_layouts = {
        "the labels after 24 sweeps": (labels24, votes),
        "the faithful flagship's labels after 8 sub-steps": (labels8, votes),
        "random labels over [-2, L+2), votes over [0, P]": (rand_labels, rand_votes),
        "one label everywhere": (one, votes),
        "every label dropped": (dropped, votes),
        "every vote P": (labels24, torch.full_like(votes, 3)),
        ragged_name: (labels24.reshape(-1)[ragged], votes.reshape(-1)[ragged]),
    }
    half = H // 2
    halves = [(labels24[rows].contiguous(), data_i[:, rows].contiguous(), votes[rows].contiguous())
              for rows in (slice(0, half), slice(half, H))]
    want_full = ktally.moment_tally_plain(labels24.reshape(-1), data_i.reshape(7, -1), num)
    want_votes = ktally.vote_tally_plain(labels24.reshape(-1), votes.reshape(-1), num, 3)
    err = {}  # max |kernel - plain| at the flagship's shapes, recorded below
    for name, (lab, d) in moment_layouts.items():
        lab, d = lab.contiguous(), d.contiguous()
        got = ktally.moment_tally(lab, d, num)
        want = ktally.moment_tally_plain(lab.reshape(-1), d.reshape(7, -1), num)
        if not torch.equal(got, want):
            raise AssertionError(f"K2 on {name}: {int((got != want).sum())} entries differ "
                                 "from the plain version")
        if lab is labels24:
            err["moment_tally"] = float((got - want).abs().max())
    for name, (lab, v) in vote_layouts.items():
        lab, v = lab.contiguous(), v.contiguous()
        got = ktally.vote_tally(lab, v, num, 3)
        want = ktally.vote_tally_plain(lab.reshape(-1), v.reshape(-1), num, 3)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 on {name}: differs from the plain version")
        if lab is labels24 and v is votes:
            err["vote_tally"] = float((got - want).abs().max())
    bottom = []
    ktally.moment_tally(halves[1][0], halves[1][1], num,
                        reduce=lambda acc: bottom.append(acc) or acc)
    summed = ktally.moment_tally(halves[0][0], halves[0][1], num,
                                 reduce=lambda acc: acc + bottom[0])
    if not torch.equal(summed, want_full):
        raise AssertionError("K2: the halves' int64 tables, summed and rounded, differ from the "
                             "full frame's plain table")
    if not torch.equal(sum(ktally.vote_tally(lab, v, num, 3) for lab, _, v in halves),
                       want_votes):
        raise AssertionError("K4: the halves' counts, summed, differ from the full frame's")
    log(f"K2 and K4 array_equal to their plain versions on "
        f"{len(moment_layouts)} and {len(vote_layouts)} layouts ("
        + "; ".join(dict.fromkeys([*moment_layouts, *vote_layouts])) + ") and on the psum path "
        "(the two halves' tables summed, K2's as int64 then rounded once)")

    k2 = lambda: ktally.moment_tally(labels24, data_i, num)
    k4 = lambda: ktally.vote_tally(labels24, votes, num, 3)
    flat24, votes_flat = labels24.reshape(-1), votes.reshape(-1)
    data_flat = data_i.reshape(7, -1)
    idx64, key = flat24.long(), flat24.long() * 3 + votes_flat.long()
    rows64 = torch.cat([torch.ones_like(data_flat[:1]), data_flat, data_flat * data_flat]).long()
    acc = torch.zeros((rows64.shape[0], num), dtype=torch.int64, device=dev)
    timings = {
        "moment_tally": (k2, lambda: ktally.moment_tally_plain(flat24, data_flat, num),
                         lambda: acc.index_add_(1, idx64, rows64), "index_add_ int64",
                         4 * n + 4 * 7 * n + 4 * 15 * num, n * (3 * 7 + 1), "K2"),
        "vote_tally": (k4, lambda: ktally.vote_tally_plain(flat24, votes_flat, num, 3),
                       lambda: torch.bincount(key, minlength=num * 3), "bincount",
                       5 * n + 4 * 3 * num, n, "K4"),
    }
    for name, (fn, plain, library, library_name, nbytes, ops, k) in timings.items():
        dms, ms = graph_ms(fn), cuda_ms(fn, 50)
        pms, lms = cuda_ms(plain, 10), cuda_ms(library, 50)
        bms, by = bound(nbytes, ops)
        results[name] = dict(max_abs_err=err[name], ms=dms, plain_ms=pms, library_ms=lms,
                             bound_ms=bms, bound_by=by, wrapper_ms=ms)
        log(f"{k} {name} at [{H},{W}] (the labels after 24 sweeps): device {dms:.4f} ms a call "
            f"(graph replay of 100 wrapper calls), wrapper {ms:.4f} ms, plain {pms:.4f} ms, "
            f"{library_name} {lms:.4f} ms, bound {bms:.4f} ms ({by}), {bms / dms:.0%} of it  "
            f"[{tag}]")


def label_tally_phase(dev, tag, t, data9, results) -> None:
    """K7 against its plain version, array_equal, at 19 and 50 columns:
      * the rows [1, d, d^2] [19, H, W] of a 9-channel init_stats (data9),
        and 50 random columns over
        the whole int32 range, on the block grid and on the labels after 24
        sweeps, each in the image layout [H, W] and flat [N];
      * +2^30 and -2^30 in every column (alternating by pixel), the
        invalid derivative's square and its negative;
      * random labels over [-2, L + 2) (a tile holds more labels than
        slots: the device-memory route);
      * a flat N that is not a multiple of the tile nor of 4 from pixel 1
        (unaligned: masked scalar loads);
      * the psum path: the two halves' int64 tables summed, then rounded.
    Then times K7 at 19 columns on the block grid's image layout (init_stats's
    route) as K2 is timed: device ms a call (graph replay of 100 wrapper
    calls), the wrapper's ms, the plain version's and index_add_ int64's
    (device ms, the same way), and records it."""
    from cartslam_tpu_torch.kernels import tally as ktally

    num, n = t["num_labels"], H * W
    labels, labels24 = t["labels"], t["labels24"]
    d9 = data9.to(torch.int32)
    rows = torch.cat([torch.ones_like(d9[:1]), d9, d9 * d9]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = torch.randint(-2**31, 2**31, (50, H, W), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    sign = 1 - 2 * (torch.arange(n, device=dev) % 2).to(torch.int32).reshape(H, W)
    big = {c: (sign * 2**30).expand(c, H, W).contiguous() for c in LABEL_TALLY_WIDTHS}
    rand_labels = torch.randint(-2, num + 2, (H, W), generator=gen, device=dev,
                                dtype=torch.int32)
    values = {19: rows, 50: wide}
    ragged = slice(1, 1 + H // SHARDS * W + 37)

    def plain(lab, v):
        c = v.shape[0]
        return ktally.label_tally_plain(lab.reshape(-1), v.reshape(c, -1).T, num).T

    layouts = []
    for c in LABEL_TALLY_WIDTHS:
        for lname, lab in (("the block grid", labels), ("the labels after 24 sweeps", labels24)):
            layouts += [(f"C={c}, {lname} [H, W]", lab, values[c]),
                        (f"C={c}, {lname} flat", lab.reshape(-1), values[c].reshape(c, -1))]
        layouts += [(f"C={c}, +-2^30", labels24, big[c]),
                     (f"C={c}, random labels over [-2, L+2)", rand_labels, values[c]),
                     (f"C={c}, a flat N = {ragged.stop - 1} from pixel 1",
                      labels24.reshape(-1)[ragged], values[c].reshape(c, -1)[:, ragged])]
    err = None
    for name, lab, v in layouts:
        lab, v = lab.contiguous(), v.contiguous()
        got, want = ktally.label_tally(lab, v, num), plain(lab, v)
        if not torch.equal(got, want):
            raise AssertionError(f"K7 label_tally on {name}: {int((got != want).sum())} of "
                                 f"{want.numel()} entries differ from the plain version")
        if lab is labels and v is rows:
            err = float((got - want).abs().max())
    half = H // 2
    bottom = []
    ktally.label_tally(labels24[half:].contiguous(), rows[:, half:].contiguous(), num,
                       reduce=lambda acc: bottom.append(acc) or acc)
    summed = ktally.label_tally(labels24[:half].contiguous(), rows[:, :half].contiguous(), num,
                                reduce=lambda acc: acc + bottom[0])
    if not torch.equal(summed, plain(labels24, rows)):
        raise AssertionError("K7: the halves' int64 tables, summed and rounded, differ from the "
                             "full frame's plain table")
    log(f"K7 label_tally array_equal to its plain version on {len(layouts)} layouts ("
        + "; ".join(name for name, _, _ in layouts) + ") and on the psum path")

    width = LABEL_TALLY_WIDTHS[0]
    flat_rows = rows.reshape(width, -1)
    idx64, vals64 = labels.reshape(-1).long(), flat_rows.T.long().contiguous()
    acc = torch.zeros((num, width), dtype=torch.int64, device=dev)
    fn = lambda: ktally.label_tally(labels, rows, num)
    dms, ms = graph_ms(fn), cuda_ms(fn, 50)
    flat_dms = graph_ms(lambda: ktally.label_tally(labels.reshape(-1), flat_rows, num))
    dms24 = graph_ms(lambda: ktally.label_tally(labels24, rows, num))
    pms = cuda_ms(lambda: plain(labels, rows), 10)
    lms = graph_ms(lambda: acc.index_add_(0, idx64, vals64))
    wide_dms = graph_ms(lambda: ktally.label_tally(labels, wide, num))
    nbytes, ops = 4 * n + 4 * n * width + 4 * num * width, n * width
    bms, by = bound(nbytes, ops)
    results["label_tally"] = dict(max_abs_err=err, ms=dms, plain_ms=pms, library_ms=lms,
                                  bound_ms=bms, bound_by=by, wrapper_ms=ms)
    log(f"K7 label_tally C={width} at [{H},{W}] (the block grid, image layout): device "
        f"{dms:.4f} ms a call (graph replay of 100 wrapper calls), wrapper {ms:.4f} ms, plain "
        f"{pms:.4f} ms, index_add_ int64 device {lms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{bms / dms:.0%} of it; device {flat_dms:.4f} ms flat, {dms24:.4f} ms on the labels "
        f"after 24 sweeps; C=50 device {wide_dms:.4f} ms  [{tag}]")


def all_shards_carries(settle, sp):
    """K5's earlier settle schedule, replayed as the reference of the exact
    one: n-1 rounds in which every shard sweeps both directions from its
    current carries and hands both on."""
    from cartslam_tpu_torch.parallel.sgm_sharded import chain_perms

    n, idx = sp.n, sp.index
    fwd, bwd = chain_perms(n)
    tb = bt = None
    for _ in range(n - 1):
        tb_fin, bt_fin = settle(tb, bt)
        tb_recv = sp.group.ppermute(tb_fin, fwd)
        bt_recv = sp.group.ppermute(bt_fin, bwd)
        tb = None if idx == 0 else tb_recv
        bt = None if idx == n - 1 else bt_recv
    return tb, bt


# K5's kernels by profiler name: (name pattern, label).
K5_KERNELS = (("sgm_settle_kernel", "settle"), ("sgm_hpaths_kernel", "row paths"),
              ("sgm_vpaths_kernel", "column paths"), ("sgm_wta_kernel", "WTA"))


def k5_device_times(dev_events) -> dict:
    """K5's device figures from profiler device events: busy ms (the union
    of its kernels' intervals), span ms (the first K5 kernel's start to the
    last one's end) and {label: [ms, launches]} by kernel."""
    spans, by = [], {label: [0.0, 0] for _, label in K5_KERNELS}
    for e in dev_events:
        label = next((lab for pat, lab in K5_KERNELS if pat in e.name), None)
        if label is None:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by[label][0] += e.time_range.elapsed_us() / 1e3
        by[label][1] += 1
    if not spans:
        return dict(busy_ms=None, span_ms=None, by_kernel=by)
    return dict(busy_ms=_union_ms(spans),
                span_ms=(max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3, by_kernel=by)


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def _k5_by_kernel(by: dict, per: float = 1.0) -> str:
    return ", ".join(f"{label} {ms / per:.4f} ms ({n / per:g})" for label, (ms, n) in by.items())


def sharded_sgm_phase(dev, tag, paths, results) -> None:
    """K5 on SHARDS row shards of the frame's census (the rows a shard's
    3-row census halo gives it), the shards as threads on this card: the
    settled carries of the exact schedule against its plain version and
    against the all-shards schedule replayed with the kernel's
    both-directions sweep; every shard's output against the plain version
    and the shards' disparity against K1's full frame.  Then K5's device
    time a frame apart from the host, from the replay of a CUDA graph of
    one run of the 8 shards (CUDA events; span, busy and time by kernel
    from the profiler), beside the same from runs as the shard threads make
    them (the host paces these) and the host-inclusive time of the call.
    Adds K5's numbers to `results`."""
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.kernels import sgm as ksgm
    from cartslam_tpu_torch.parallel.group import ShardGroup
    from cartslam_tpu_torch.parallel.sgm_sharded import sgm_census_sharded, settled_carries
    from cartslam_tpu_torch.runtime.module import SpatialContext

    cl, cr = paths["census"]
    hl = H // SHARDS
    group = ShardGroup(SHARDS, [dev] * SHARDS)
    sp = SpatialContext(group, hl)
    rows = [[c[i * hl:(i + 1) * hl].contiguous() for c in (*cl, *cr)] for i in range(SHARDS)]
    ckw = dict(min_disparity=4, num_disparities=D, p1=10, p2=120)
    kw = dict(ckw, uniqueness=12, subpixel=True, lr_check=True)

    def exact(vcarry):
        return group.run(lambda i: settled_carries(
            lambda tb, bt, down, up: vcarry(*rows[i], tb, bt, top_down=down, bottom_up=up, **ckw),
            sp))

    build.reset_counts()
    got_k = exact(ksgm.sgm_vcarry)
    torch.cuda.synchronize()
    settle_launches = ksgm.SETTLE_COUNTER.launches
    if settle_launches != SETTLE_LAUNCHES:
        raise AssertionError(f"K5: the settle chain launched {settle_launches} sweeps, expected "
                             f"{SETTLE_LAUNCHES}")
    got_p = exact(ksgm.sgm_vcarry_plain)
    got_o = group.run(lambda i: all_shards_carries(
        lambda tb, bt: ksgm.sgm_vcarry(*rows[i], tb, bt, **ckw), sp))
    checked = 0
    for i, (k, p, o) in enumerate(zip(got_k, got_p, got_o)):
        for d, name in enumerate(("top-down", "bottom-up")):
            for what, ref in (("the plain version's", p[d]), ("the all-shards schedule's", o[d])):
                a = k[d]
                if (a is None) != (ref is None) or (a is not None and not torch.equal(a, ref)):
                    raise AssertionError(f"K5 shard {i}: the settled {name} carry differs from "
                                         f"{what}")
            checked += k[d] is not None
    shards = lambda: group.run(lambda i: sgm_census_sharded(*rows[i], sp, **kw))
    kernel = lambda: torch.cat(shards())
    plain = lambda: torch.cat(group.run(
        lambda i: sgm_census_sharded(*rows[i], sp, plain=True, **kw)))
    build.reset_counts()
    out_k = kernel()
    torch.cuda.synchronize()
    counts = {c.name: (c.launches, c.plain_calls) for c in build.COUNTERS.values()}
    if (counts["sgm_sharded"] != (SHARDS, 0) or counts["sgm_settle"] != (SETTLE_LAUNCHES, 0)
            or any(pc for _, pc in counts.values())):
        raise AssertionError(f"K5: launches (sgm_sharded, sgm_settle) {counts}, expected "
                             f"({SHARDS}, {SETTLE_LAUNCHES}) and no plain call")
    out_p, pms = timed_once(plain)  # the plain chain takes seconds: one timed run
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"K5: {int((out_k != out_p).sum())} pixels differ from the plain "
                             "version")
    if not torch.equal(out_k, paths["k1_disparity"]):
        n = int((out_k != paths["k1_disparity"]).sum())
        raise AssertionError(f"K5: the {SHARDS}-shard disparity differs from K1's full frame "
                             f"on {n} pixels")
    wrapper_ms = cuda_ms(kernel, 10)
    # As the shard threads run it, under the profiler: the host paces it.
    eager = _median_run([profiled_k5(shards) for _ in range(K5_PROFILE_RUNS)])
    # Device time apart from the host: one group.run of the 8 shards captured
    # into a CUDA graph (the shard threads enqueue on the capturing stream,
    # and their side streams join the capture through the forks), replayed.
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out_g = shards()
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(torch.cat(out_g), out_k):
        raise AssertionError("K5: the replayed CUDA graph's disparity differs from the kernel's")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(K5_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / K5_REPLAYS
    replay = _median_run([profiled_k5(graph.replay) for _ in range(K5_PROFILE_RUNS)])
    del graph, out_g
    torch.cuda.empty_cache()
    for what, r in (("run", eager), ("replay", replay)):
        for label, (_, n) in r["by_kernel"].items():
            want = SETTLE_LAUNCHES if label == "settle" else SHARDS
            if r["span_ms"] is not None and n != want:
                raise AssertionError(f"K5 {what}: the profiler saw {n} {label} launches, "
                                     f"expected {want}")
    nbytes = 4 * H * W * 4 + H * W * 2
    ops = H * W * D * (SGM_FUSED_OPS_PER_CELL + (SHARDS - 1) / SHARDS * SGM_SETTLE_OPS_PER_CELL)
    bms, by = bound(nbytes, ops)
    results["sgm_sharded"] = dict(
        max_abs_err=float((out_k.int() - out_p.int()).abs().max()), ms=ms, plain_ms=pms,
        library_ms=None, bound_ms=bms, bound_by=by, span_ms=replay["span_ms"],
        busy_ms=replay["busy_ms"], eager_span_ms=eager["span_ms"], wrapper_ms=wrapper_ms)
    log(f"K5 sgm_sharded: {SHARDS} shards of [{hl},{W}] D={D} on one card; {checked} settled "
        f"carries array_equal to the plain version and to the all-shards schedule (kernel, "
        f"both directions); every shard's output, and a CUDA graph's replay of the 8 shards, "
        f"array_equal to the plain version; the shards' disparity array_equal to K1's full "
        f"frame; launches a frame: sgm_sharded {SHARDS}, sgm_settle {settle_launches}; plain "
        f"{pms:.3f} ms")
    log(f"K5 device time a frame, apart from the host (a CUDA graph of one group.run of the "
        f"{SHARDS} shards, replayed): {ms:.4f} ms a replay (CUDA events, {K5_REPLAYS} "
        f"replays); profiler, {K5_PROFILE_RUNS} replays, the one of median span: span "
        f"{_ms(replay['span_ms'])}, busy {_ms(replay['busy_ms'])}; "
        f"{_k5_by_kernel(replay['by_kernel'])}; spans {replay['spans']}; K1 in this call "
        f"{results['sgm']['ms']:.4f} ms  [{tag}]")
    log(f"K5 as the shard threads run it (profiler, {K5_PROFILE_RUNS} runs, the one of median "
        f"span; the host paces it): span {_ms(eager['span_ms'])}, busy "
        f"{_ms(eager['busy_ms'])}; {_k5_by_kernel(eager['by_kernel'])}; spans "
        f"{eager['spans']}; host-inclusive (CUDA events around group.run and the cat, the "
        f"shard threads' host work included) {wrapper_ms:.4f} ms  [{tag}]")


def profiled_k5(fn) -> dict:
    """k5_device_times of one call of fn under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return k5_device_times([e for e in prof.events() if e.device_type == cuda])


def _median_run(runs: list) -> dict:
    """The run of median span, with every run's span (ms, 4 decimals);
    runs whose profile holds no K5 kernel are left out and counted (all
    None, and "not measured", when no run has one)."""
    seen = sorted((r for r in runs if r["span_ms"] is not None), key=lambda r: r["span_ms"])
    spans = ", ".join(f"{r['span_ms']:.4f}" for r in seen) or "not measured"
    if len(seen) < len(runs):
        spans += f" ({len(runs) - len(seen)} of {len(runs)} profiles without K5 kernels)"
    med = seen[len(seen) // 2] if seen else k5_device_times([])
    return dict(med, spans=spans)


def shard_kernels_phase(dev, paths) -> None:
    """K2, K3 and K4 at the shapes the spatial path gives them, each against
    its plain version on the card, on SHARDS row shards of the flagship's
    block labels and 7 data channels, with the superpixels' label halos of
    8 and 24 rows (-1 labels beyond the frame, as models/superpixels.py
    exchanges them):
      * init_stats(psum=...) on each halo-extended shard (K2 with its
        int64 table psum'd, then tally_to_float) against moment_tally_plain
        with the same reduce, and against the full frame's K2 table;
      * K3's sweeps (as many as halo rows) on the halo-extended rows of
        shards 0 and 1, labels and stat image;
      * K4 on each shard's rows against its plain version, and the psum of
        the shards' tables against the full frame's."""
    from cartslam_tpu_torch.kernels import relax as krelax
    from cartslam_tpu_torch.kernels import tally as ktally
    from cartslam_tpu_torch.ops.superpixels import init_stats
    from cartslam_tpu_torch.parallel.group import ShardGroup
    from cartslam_tpu_torch.runtime.module import SpatialContext

    hl, num = H // SHARDS, paths["num_labels"]
    labels, votes = paths["labels"], paths["votes"]
    data = paths["data9"][:7].contiguous()  # deriv x2, YCrCb, x, y
    group = ShardGroup(SHARDS, [dev] * SHARDS)
    sp = SpatialContext(group, hl)
    full_stats = init_stats(labels, data, num)
    vote_rows = votes.reshape(H, W)
    full_votes = ktally.vote_tally(labels, vote_rows, num, 3)
    xs = torch.arange(W, dtype=torch.float32, device=dev)

    def shard(i, halo):
        lab = sp.slice_rows(labels)
        lab_ext = sp.exchange(lab, halo, halo, fill=-1)
        # The 5 image channels with edge halos, then the global pixel
        # coordinates of the extended rows (relax's implicit compactness data).
        img = sp.exchange(sp.slice_rows(data[:5].permute(1, 0, 2)), halo, halo)
        ys = torch.arange(sp.row0 - halo, sp.row0 + hl + halo, dtype=torch.float32, device=dev)
        n_ext = hl + 2 * halo
        data_ext = torch.cat([img.permute(1, 0, 2), xs[None, None].expand(1, n_ext, W),
                              ys[None, :, None].expand(1, n_ext, W)]).contiguous()
        core = torch.zeros(n_ext, dtype=torch.bool, device=dev)
        core[halo:halo + hl] = True
        tally = torch.where(core[:, None], lab_ext, krelax.OOB)
        stats_k = init_stats(tally, data_ext, num, psum=sp.psum)
        stats_p = ktally.moment_tally_plain(tally.reshape(-1), data_ext.reshape(7, -1).to(
            torch.int32), num, reduce=sp.psum)
        vl, vv = lab.contiguous(), sp.slice_rows(vote_rows).contiguous()
        votes_k = ktally.vote_tally(vl, vv, num, 3)
        votes_p = ktally.vote_tally_plain(vl.reshape(-1), vv.reshape(-1), num, 3)
        return (lab_ext.contiguous(), data_ext, stats_k, stats_p, votes_k, votes_p,
                sp.psum(votes_k))

    for halo in (8, 24):
        for i, (lab_ext, data_ext, stats_k, stats_p, votes_k, votes_p, votes_sum) in enumerate(
                group.run(lambda i: shard(i, halo))):
            where = f"shard {i} of [{hl + 2 * halo},{W}]"
            if not (torch.equal(stats_k, stats_p) and torch.equal(stats_k, full_stats)):
                raise AssertionError(f"K2 {where}: the psum'd stat table differs from the "
                                     "plain version's or the full frame's")
            if halo == 8 and not (torch.equal(votes_k, votes_p)
                                  and torch.equal(votes_sum, full_votes)):
                raise AssertionError(f"K4 shard {i} of [{hl},{W}]: the vote table differs "
                                     "from the plain version's or the full frame's")
            if i > 1:
                continue
            # K3 as models/superpixels.py calls it on a shard: as many sweeps
            # as halo rows, from the psum'd table.
            args = (lab_ext, stats_k, data_ext, paths["feats"], 7, halo, 0.5, 0.5 / np.sqrt(2))
            lk, sk = krelax.relax_sweeps(*args, return_stats=True)
            lp, spl = krelax.relax_sweeps_plain(*args, return_stats=True)
            ndiff, moved = int((lk != lp).sum()), int(((lk != lab_ext) & (lab_ext >= 0)).sum())
            if ndiff > RELAX_LABEL_BOUND or moved == 0 or not torch.equal(sk, spl):
                raise AssertionError(f"K3 {where}: {ndiff} labels differ from the plain "
                                     f"version (bound {RELAX_LABEL_BOUND}), {moved} moved, or "
                                     "the stat image differs")
    log(f"shard shapes, {SHARDS} shards: K2 on [{hl + 16},{W}] and [{hl + 48},{W}] halo rows "
        f"(int64 tables psum'd, then tally_to_float) array_equal to the plain version and to "
        f"the full frame's table; K3 8 and 24 sweeps (as many as halo rows) on shards 0 and "
        f"1, 0 labels differ, stat images equal; K4 on [{hl},{W}] array_equal to the plain version, psum'd equal to the full "
        f"frame's table")


def entry_point_paths(paths) -> dict:
    """K6 and K7 through their own entry points, counts from 0 each."""
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.kernels import sgm as ksgm
    from cartslam_tpu_torch.ops import superpixels as sp

    counts = {}
    cl, cr = paths["census"]
    build.reset_counts()
    vol = ksgm.sgm_aggregate(*cl, *cr, min_disparity=4, num_disparities=D, p1=10, p2=120)
    torch.cuda.synchronize()
    counts["sgm_aggregate"] = build.COUNTERS["sgm_aggregate"].launches
    if vol.shape != (H, W, D) or build.COUNTERS["sgm_aggregate"].plain_calls:
        raise AssertionError("sgm_aggregate entry point did not run its kernel")
    del vol
    torch.cuda.empty_cache()
    build.reset_counts()
    stats = sp.init_stats(paths["labels"], paths["data9"], paths["num_labels"])
    torch.cuda.synchronize()
    counts["label_tally"] = build.COUNTERS["label_tally"].launches
    if (stats.shape != (19, paths["num_labels"]) or build.COUNTERS["moment_tally"].launches
            or build.COUNTERS["label_tally"].plain_calls):
        raise AssertionError("init_stats with 9 channels did not go through K7")
    if int(stats[0].sum()) != H * W:
        raise AssertionError("init_stats: the counts do not add up to the pixels")
    log(f"entry points: sgm_aggregate launched K6 {counts['sgm_aggregate']}x; 9-channel "
        f"init_stats launched K7 {counts['label_tally']}x, K2 0x")
    return counts


def drive(pipe, source, expected, keep=None):
    """One run of the pipeline `pipe` over `source` with the counts set to 0
    just before it and read just after.  Returns (pipeline, result, per-frame
    ms, last outputs, launch counts); with a list `keep`, every frame's
    outputs are appended to it (they stay on the card)."""
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.runtime import run

    events, last = [], {}

    def on_frame(fid, outputs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        for k, v in outputs.items():
            if v.device.type != "cuda":
                raise AssertionError(f"frame {fid}: output {k} is on {v.device}")
        last.update(outputs)
        if keep is not None:
            keep.append(outputs)

    build.reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    res = run(pipe, source, on_frame=on_frame)
    torch.cuda.synchronize()
    counts = {c.name: (c.launches, c.plain_calls) for c in build.COUNTERS.values()}
    _counts_equal("run loop", counts, expected)
    frame_ms = [start.elapsed_time(events[0])]
    frame_ms += [events[i - 1].elapsed_time(events[i]) for i in range(1, len(events))]
    return pipe, res, frame_ms, last, {k: v[0] for k, v in counts.items()}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shape, dtype and values (NaN equal to NaN), on the card."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(torch.allclose(a, b, rtol=0, atol=0, equal_nan=True))
    return torch.equal(a, b)


def spatial_phase(frames, intrinsics, dev, tag, plan, n_frames=SPATIAL_FRAMES,
                  superpixels=None, keys=("full_frame_select", "spatial")) -> tuple[int, list]:
    """configs/kitti-planeseg-spatial.json through read_config, the synthetic
    frames standing in for KITTI, n_frames frames on SHARDS row shards of
    this one card; every output equal frame by frame to the full-frame
    pipeline of the same modules with warp_mode 'select' (the spatial mode's
    warp) and the same max_warp_y.  superpixels: keys set on the config's
    superpixels module (then both pipelines come from build_pipeline with
    the config's parallel block).  keys: the launch plans of the full frame
    and the spatial run.  Returns (K5 launches, per-frame ms)."""
    from cartslam_tpu_torch.config import build_pipeline, read_config
    from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
    from cartslam_tpu_torch.sources import PreloadedSource

    cfg = os.path.join(REPO, "configs", "kitti-planeseg-spatial.json")
    with open(cfg) as f:
        config = json.load(f)
    mods = [{**m, **superpixels} if superpixels and m["type"] == "superpixels" else m
            for m in config["modules"]]
    ref_mods = [{**m, "warp_mode": "select", "max_warp_y": m.get("max_warp_y", 32)}
                if m["type"] == "superpixel_disparity_planeseg" else m for m in mods]
    src = lambda: PreloadedSource(frames[:n_frames], intrinsics=intrinsics)
    want, got = [], []
    drive(*build_pipeline(src(), ref_mods, device=dev), plan[keys[0]], keep=want)
    if superpixels:
        pipe, source = build_pipeline(src(), mods, device=dev, parallel=config["parallel"])
    else:
        pipe, source = read_config(cfg, device=dev, source=src())
    if not isinstance(pipe, SpatialPipeline) or pipe.n != SHARDS:
        raise AssertionError(f"{cfg} did not build a {SHARDS}-shard SpatialPipeline")
    torch.cuda.reset_peak_memory_stats(dev)
    _, res, frame_ms, _, counts = drive(pipe, source, plan[keys[1]], keep=got)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    if res.frames != n_frames:
        raise AssertionError(f"spatial: ran {res.frames} frames, expected {n_frames}")
    for fid, (a, b) in enumerate(zip(got, want), start=1):
        if set(a) != set(b):
            raise AssertionError(f"spatial frame {fid}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            if not _same(a[k], b[k]):
                raise AssertionError(f"spatial frame {fid}: {k} differs from the full frame")
    how = f"with superpixels {superpixels}" if superpixels else "via read_config"
    log(f"spatial: {cfg[len(REPO) + 1:]} {how}, {SHARDS} shards of "
        f"{H // SHARDS} rows on one card, {res.frames} frames: every output "
        f"({', '.join(sorted(got[0]))}) array_equal frame by frame to the full-frame "
        f"pipeline with warp_mode 'select', max_warp_y 32; launches {counts}, no plain "
        f"call; peak device memory {peak_mb:.1f} MiB")
    log(f"spatial per-frame ms ({how}): median {float(np.median(frame_ms[2:])):.3f} over "
        f"frames 3..{n_frames} (min {min(frame_ms[2:]):.3f}, max {max(frame_ms[2:]):.3f}); "
        f"frame 1 {frame_ms[0]:.3f}; {SHARDS} shards on one card, not a latency figure  [{tag}]")
    return counts["sgm_sharded"], frame_ms


def faithful_paths(frames, intrinsics, gen, dev, tag, plan) -> list:
    """The paths of the reference-faithful modes, each driven with its own
    counts: the faithful flagship (FRAMES frames), the pixel plane
    segmentation in both temporal modes (PIXEL_FRAMES) and the flagship on
    grayscale frames (GRAY_FRAMES).  Returns the faithful flagship's
    per-frame ms."""
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.sources import PreloadedSource

    src = lambda n: PreloadedSource(frames[:n], intrinsics=intrinsics)
    torch.cuda.reset_peak_memory_stats(dev)
    pipe, res, frame_ms, last, counts = drive(*build_pipeline(src(FRAMES), faithful_modules(),
                                                              device=dev), plan["faithful"])
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    if res.frames != FRAMES or res.state["modules"]["SPPlaneSegmentation"]:
        raise AssertionError("faithful flagship: wrong frame count, or a carried vote state")
    log(f"faithful flagship ('phase' stats, 2 relax phases, faithful temporal vote): "
        f"{res.frames} frames at {H}x{W}, D={D}; launches {counts}; history rings "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in res.state["history"].items())
        + f"; peak device memory {peak_mb:.1f} MiB")
    check_flagship_outputs(res, last, gen)
    del pipe, res, last
    for mode in ("carried", "faithful"):
        _, res, ms, last, counts = drive(*build_pipeline(src(PIXEL_FRAMES), pixel_modules(mode),
                                                         device=dev), plan["pixel"])
        planes, hist = last["planes"], last["planeseg_frame_histogram"]
        vals = set(torch.unique(planes).tolist())
        if planes.shape != (H, W) or not vals <= {0, 1, 2} or int(hist.sum()) == 0:
            raise AssertionError(f"pixel plane segmentation ({mode}): planes {vals}, "
                                 f"histogram sum {int(hist.sum())}")
        changed = float((planes != last["planes_unsmoothed"]).float().mean())
        log(f"pixel plane segmentation (kitti-naive-segmentation-temporal.json, {mode} vote): "
            f"{res.frames} frames; launches {counts}; planes classes "
            f"{np.bincount(planes.cpu().numpy().ravel(), minlength=3).tolist()}, {changed:.4f} "
            f"changed by the vote, ranges {res.host_params['PlaneSegmentation']['ranges'].tolist()}"
            f"; per-frame median {float(np.median(ms[2:])):.3f} ms over frames 3..{PIXEL_FRAMES}"
            f"  [{tag}]")
    _, res, ms, last, counts = drive(*build_pipeline(src(GRAY_FRAMES), flagship_modules(),
                                                     device=dev, grayscale=True),
                                     plan["grayscale"])
    if last["superpixels"].shape != (H, W) or last["planes"].shape != (H, W):
        raise AssertionError("grayscale flagship: wrong output shapes")
    from cartslam_tpu_torch.kernels import relax as krelax

    gray_feats = [krelax.RelaxFeature("gaussian", 0, 2, 1.0),
                  krelax.RelaxFeature("gaussian", 2, 1, 1.5),
                  krelax.RelaxFeature("compactness", 3, 2, 0.1)]
    log(f"grayscale flagship (frames converted at the source boundary): {res.frames} frames; "
        f"launches {counts}, K3 as {krelax.instantiation(gray_feats, 5)}; per-frame median "
        f"{float(np.median(ms[2:])):.3f} ms over frames 3..{GRAY_FRAMES}  [{tag}]")
    return frame_ms


def check_flagship_outputs(res, last, gen):
    planes = last["planes"]
    vals = set(torch.unique(planes).tolist())
    if planes.shape != (H, W) or planes.dtype != torch.uint8 or not vals <= {0, 1, 2}:
        raise AssertionError(f"planes: shape {tuple(planes.shape)}, values {vals}")
    ranges = res.host_params["SPPlaneSegmentation"]["ranges"].tolist()
    hist = np.bincount(planes.cpu().numpy().ravel(), minlength=3).tolist()
    changed = float((last["planes_unsmoothed"] != planes).float().mean())
    log(f"planes classes {hist} (H, V, U); provider ranges {ranges}; {changed:.4f} of pixels "
        "differ from the unsmoothed classification")
    # The synthetic camera pans 2 px per frame: cur[x] = prev[x + 2], so the
    # flow (current -> previous) is (-2, 0) px, (-64, 0) in S10.5.
    flow = last["optflow"].cpu().numpy()
    if flow.shape != (H, W, 2) or flow.dtype != np.int16:
        raise AssertionError(f"optflow: shape {flow.shape}, dtype {flow.dtype}")
    pan = float(((flow[..., 0] == -64) & (flow[..., 1] == 0)).mean())
    log(f"optflow frame {FRAMES}: {pan:.4f} of pixels at the camera pan (-2, 0) px")
    if pan < 0.8:
        raise AssertionError("optflow does not follow the synthetic camera pan")
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
        raise AssertionError("flagship disparity/depth out of bounds")


def _assert_equal_trees(a, b, where):
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            _assert_equal_trees(a[k], b[k], f"{where}/{k}")
        return
    if where.endswith("/depth"):
        # Elementwise IEEE ops in the same order on both devices; the
        # relative bound (~3 ulp) only guards against a reordering.
        fin = np.isfinite(a)
        if not (np.array_equal(np.isfinite(b), fin)
                and np.allclose(a[fin], b[fin], rtol=4e-7, atol=0)):
            raise AssertionError(f"{where}: depth differs card vs CPU")
    elif not np.array_equal(a, b):
        n = int((np.asarray(a) != np.asarray(b)).sum())
        raise AssertionError(f"{where}: differs card vs CPU on {n} of {np.size(a)} values")


def small_temporal_check(dev, faithful=False):
    """A 64x128 temporal slice for 6 frames on the card and on the CPU:
    kernels vs plain versions end to end, every output and the final state
    equal (depth within ~3 ulp).  48 disparities from 0, as in
    configs/synthetic-planeseg.json, so K1's last lane chunk is partial.
    faithful: the reference-faithful modes ('phase' statistics, 2 relax
    phases, the faithful temporal vote)."""
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.runtime import run, state_to_numpy
    from cartslam_tpu_torch.sources import SyntheticDataSource

    mods = [
        {"type": "superpixels", "initial_iterations": 3, "iterations": 2, "block_size": 8,
         "reset_iterations": 4},
        {"type": "optflow"},
        {"type": "disparity", "num_disparities": 48, "min_disparity": 0,
         "smoothing_radius": 2, "smoothing_iterations": 1},
        {"type": "disparity_derivative"},
        {"type": "depth"},
        {"type": "superpixel_disparity_planeseg", "parameter_provider": {"type": "histogram_peak"},
         "update_interval": 3, "use_temporal_smoothing": True},
    ]
    if faithful:
        mods[0] = {**mods[0], "stats_refresh": "phase", "relax_phases": 2}
        mods[-1] = {**mods[-1], "temporal_mode": "faithful"}
    name = "small faithful slice" if faithful else "small temporal slice"
    runs = {}
    for device in ("cpu", dev):
        src = SyntheticDataSource(image_size=(64, 128), num_frames=6, seed=0,
                                  max_disparity=22.4, baseline=20.0)
        pipe, src = build_pipeline(src, mods, device=device)
        frames = []
        res = run(pipe, src, on_frame=lambda fid, o: frames.append(state_to_numpy(o)))
        runs[str(device)] = (frames, state_to_numpy(res.state))
    (cpu_frames, cpu_state), (dev_frames, dev_state) = runs["cpu"], runs[str(dev)]
    for fid, (a, b) in enumerate(zip(cpu_frames, dev_frames), start=1):
        _assert_equal_trees(a, b, f"{name} frame {fid}")
    _assert_equal_trees(cpu_state, dev_state, f"{name} final state")
    if not (cpu_frames[-1]["optflow"] != 0).any():
        raise AssertionError(f"{name}: zero flow")
    log(f"{name} (64x128, D=48, 6 frames): card == CPU on every output and the final state "
        "(flow, superpixels, planes, vote state and history rings exact; depth within ~3 ulp)")


def full_flow_check(frames, dev, tag) -> float:
    """dense_flow at 376x1248 on one frame pair, card against CPU; returns
    its ms on the card."""
    from cartslam_tpu_torch.ops import color
    from cartslam_tpu_torch.ops import optflow as fops

    grays = {}
    for device in ("cpu", dev):
        g = [color.bgr_to_gray(torch.from_numpy(frames[i]["left"]).to(device)) for i in (1, 0)]
        grays[str(device)] = g
    on_cpu = fops.dense_flow(*grays["cpu"])
    on_dev = fops.dense_flow(*grays[str(dev)])
    if not torch.equal(on_cpu, on_dev.cpu()):
        n = int((on_cpu != on_dev.cpu()).sum())
        raise AssertionError(f"full-size flow: {n} values differ card vs CPU")
    ms = cuda_ms(lambda: fops.dense_flow(*grays[str(dev)]), 10)
    with OpCount() as ops:
        fops.dense_flow(*grays[str(dev)])
    log(f"full-size flow [{H},{W}] frames 1->2: card == CPU (float32 flow, all "
        f"{on_cpu.numel()} values); dense_flow {ms:.3f} ms on the card, {ops.n} ATen ops "
        f"dispatched per call  [{tag}]")
    return ms


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


def profile_phase(frames, intrinsics, dev, tag, modules=None, label="profile"):
    """Where the time goes, all from ONE run of a fresh temporal flagship:
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
                                  modules or flagship_modules(), device=dev)
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
    log(f"{label} frames {first}..{last}: per-module device span median (CUDA events "
        f"around compute, launch gaps included): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(med.items(), key=lambda kv: -kv[1]))
        + f"  [{tag}]")
    _device_report(prof, n, wall, f"{label} frames {first}..{last}", tag)


def _device_report(prof, n: int, wall: float, label: str, tag: str) -> dict:
    """Device busy ms, idle share and device ms by kernel name per frame,
    from a profile of n frames that took `wall` ms each on the host.
    Returns the wall, busy (None: not measured) and idle share."""
    cuda = torch.autograd.DeviceType.CUDA
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    if not dev_events:
        log(f"{label}: wall {wall:.3f} ms/frame (profiler on); device busy and idle share "
            f"not measured (no device events)  [{tag}]")
        return {"wall": wall, "busy": None, "idle": None}
    busy = _union_ms((e.time_range.start, e.time_range.end) for e in dev_events) / n
    log(f"{label}: wall {wall:.3f} ms/frame (profiler on), device busy {busy:.3f} ms/frame, "
        f"idle share {1 - busy / wall:.4f} ({len(dev_events) / n:.0f} device events/frame)"
        f"  [{tag}]")
    by_name: dict[str, list] = {}
    for e in dev_events:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]
    log(f"{label}: device ms per frame by name: "
        + "; ".join(f"{k[:60]} {sum(v) / 1e3 / n:.3f} ({len(v) / n:g}/frame)" for k, v in top))
    tally = {k: [t for name, v in by_name.items() if k in name for t in v]
             for k in ("moment_tally", "vote_tally")}
    log(f"{label}: K2 and K4 device ms per frame: "
        + ", ".join(f"{k} {sum(v) / 1e3 / n:.4f} ({len(v) / n:g} launches/frame, "
                    f"{sum(v) / 1e3 / max(len(v), 1):.4f} each)" for k, v in tally.items())
        + f"  [{tag}]")
    return {"wall": wall, "busy": busy, "idle": 1 - busy / wall}


def spatial_profile(frames, intrinsics, dev, tag) -> None:
    """A fresh spatial run of SPATIAL_PROFILE_FRAMES under torch.profiler:
    device busy time, idle share and device time by kernel name."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from cartslam_tpu_torch.config import read_config
    from cartslam_tpu_torch.runtime import run
    from cartslam_tpu_torch.sources import PreloadedSource

    first, last = SPATIAL_PROFILE_FRAMES
    pipe, source = read_config(os.path.join(REPO, "configs", "kitti-planeseg-spatial.json"),
                               device=dev, source=PreloadedSource(frames[:last],
                                                                  intrinsics=intrinsics))
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
    label = f"spatial profile frames {first}..{last}"
    _device_report(prof, n, window["wall_ms"] / n, label, tag)
    cuda = torch.autograd.DeviceType.CUDA
    k5 = k5_device_times([e for e in prof.events() if e.device_type == cuda])
    if k5["busy_ms"] is None:
        log(f"{label}: K5 kernels not measured (no device events)  [{tag}]")
        return
    if k5["by_kernel"]["settle"][1] != SETTLE_LAUNCHES * n:
        raise AssertionError(f"{label}: {k5['by_kernel']['settle'][1]} settle sweeps, expected "
                             f"{SETTLE_LAUNCHES * n}")
    log(f"{label}: K5 device ms a frame by kernel (launches a frame): "
        f"{_k5_by_kernel(k5['by_kernel'], n)}; K5 busy {k5['busy_ms'] / n:.4f} ms a frame  "
        f"[{tag}]")


SYSTEM_DEPTH = 4  # the System's default max_in_flight
SYSTEM_PROFILE_FRAMES = (3, 12)
# Every key the flagship's step provides: the system phase fetches them all.
SYSTEM_KEYS = ("disparity", "disparity_derivative", "disparity_derivative_histogram", "depth",
               "optflow", "superpixels", "superpixels_max_label", "planes", "planes_unsmoothed")


def sync_free_step_check(frames, intrinsics, dev) -> None:
    """One warm eager step of the flagship under
    torch.cuda.set_sync_debug_mode("error"): any read back to the host or
    copy from pageable host memory inside the step body raises (such a call
    is also illegal while a stream captures)."""
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.runtime.loop import frame_to_device
    from cartslam_tpu_torch.sources import PreloadedSource

    pipe, _ = build_pipeline(PreloadedSource(frames[:2], intrinsics=intrinsics),
                             flagship_modules(), device=dev)
    state = pipe.init_state()
    params = pipe.device_params(pipe.init_host_params())
    for fid in (1, 2):
        frame, _ = pipe.prepare(frame_to_device(frames[fid - 1], fid, dev), params)
        torch.cuda.synchronize()
        if fid == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = pipe.compute_step(state, frame, params, pipe.variant(fid))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("system: a warm eager flagship step ran under set_sync_debug_mode('error'): no "
        "synchronising call in the step body")


def _frame_end_events(system, ends: list, on_dispatch=None):
    """Record a CUDA event after each frame's dispatch (its step and its
    fetch copies) on the System's stream: the frame's end on the device.
    on_dispatch(frame count) runs before each event is recorded."""
    stage = system._stage

    def staged(outputs):
        slot = stage(outputs)
        if on_dispatch is not None:
            on_dispatch(len(ends) + 1)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        return slot
    system._stage = staged


def _fetched_equal(a: dict, b: dict) -> list:
    """Keys whose arrays differ (shape, dtype or values; NaN equal to NaN)."""
    bad = []
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k), b.get(k)
        if x is None or y is None or x.shape != y.shape or x.dtype != y.dtype or not \
                np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            bad.append(k)
    return bad


def system_phase(frames, intrinsics, dev, tag, plan, modules, label, plan_key) -> dict:
    """`modules` for FRAMES frames through the System (build_system, the
    CLI's host loop) at max_in_flight=SYSTEM_DEPTH: once with module_timing
    (the eager step, module by module) and once with the captured step (a
    CUDA graph per variant, replayed).  Every fetched output of every frame
    (all of the step's keys) and the final state must be equal, the replayed
    run's launches equal to the plan with no plain call.  Prints both runs'
    per-frame medians (CUDA events between frame ends, frames 3..FRAMES),
    the graphs with their capture seconds and the peak device memory."""
    from cartslam_tpu_torch.sources import PreloadedSource

    runs = {}
    for mode in ("eager", "captured", "host keys"):
        r = run_system(PreloadedSource(frames[:FRAMES], intrinsics=intrinsics), modules, dev,
                       f"{label} {mode}", plan[plan_key], frames=FRAMES,
                       module_timing=mode == "eager", max_in_flight=SYSTEM_DEPTH,
                       extra_fetch_keys=() if mode == "host keys" else SYSTEM_KEYS)
        system = r.pop("system")
        provided = {k for m in system.pipeline.modules for k in m.provides()}
        if provided != set(SYSTEM_KEYS):
            raise AssertionError(f"{label}: the step provides {sorted(provided)}")
        if system.captured != (mode != "eager"):
            raise AssertionError(f"{label}: System.captured is {system.captured} in the "
                                 f"{mode} run")
        runs[mode] = dict(r, state=system.final_state)
        del system, r
        torch.cuda.empty_cache()
    eager, cap, host = runs["eager"], runs["captured"], runs["host keys"]
    for fid in range(1, FRAMES + 1):
        bad = _fetched_equal(cap["seen"][fid], eager["seen"][fid])
        bad += _fetched_equal(host["seen"][fid],
                              {k: eager["seen"][fid][k] for k in host["seen"][fid]})
        if bad:
            raise AssertionError(f"{label} frame {fid}: captured != eager on {bad}")
    for r in (cap, host):
        _assert_state_equal(r["state"], eager["state"], f"{label} final state")
    med = {m: float(np.median(r["ms"][1:])) for m, r in runs.items()}
    log(f"system {label}: {FRAMES} frames at max_in_flight={SYSTEM_DEPTH}, the captured run "
        f"equal to the eager (module_timing) run on every fetched output of every frame "
        f"({', '.join(sorted(cap['seen'][1]))}) and on the final state; replayed launches "
        f"{cap['counts']} (plan '{plan_key}', no plain call); graphs {len(cap['graphs'])} "
        f"(variant: capture s) {cap['graphs']}; peak device memory captured "
        f"{cap['peak']:.1f} MiB, eager {eager['peak']:.1f} MiB")
    log(f"system {label} per-frame ms (CUDA events between frame ends, frames 3..{FRAMES}): "
        f"captured median {med['captured']:.3f} (min {min(cap['ms'][1:]):.3f}, max "
        f"{max(cap['ms'][1:]):.3f}); eager module_timing median {med['eager']:.3f}; captured "
        f"fetching the host keys only ({', '.join(sorted(host['seen'][1]))}) median "
        f"{med['host keys']:.3f} (min {min(host['ms'][1:]):.3f}, max "
        f"{max(host['ms'][1:]):.3f}), graphs {host['graphs']}  [{tag}]")
    return {"median_ms": med, "counts": cap["counts"], "graphs": cap["graphs"],
            "peak_mib": cap["peak"], "last": cap["seen"][FRAMES]}


def _assert_state_equal(a, b, where):
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            _assert_state_equal(a[k], b[k], f"{where}/{k}")
    elif a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f"):
        raise AssertionError(f"{where}: differs")


def system_profile(frames, intrinsics, dev, tag, modules=None, label="captured profile",
                   parallel=None, captured=True) -> dict:
    """A fresh System run of the flagship (or of `modules`, with a
    `parallel` block) with frames SYSTEM_PROFILE_FRAMES (dispatch counts)
    under torch.profiler, captured or (captured=False) with the eager step:
    wall time a frame, device busy time and idle share, device time by
    kernel.  Returns _device_report's numbers."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.sources import PreloadedSource

    first, last = SYSTEM_PROFILE_FRAMES
    system = build_system(PreloadedSource(frames[:last], intrinsics=intrinsics),
                          modules or flagship_modules(), device=dev,
                          max_in_flight=SYSTEM_DEPTH, parallel=parallel)
    system.captured = captured and system.captured
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_dispatch(k):
        if k == first - 1:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif k == last:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    ends = []
    _frame_end_events(system, ends, on_dispatch)
    system.run()
    n = last - first + 1
    return _device_report(prof, n, window["wall_ms"] / n, f"{label} frames {first}..{last}",
                          tag)


# ---------------------------------------------------------- spatial System
def spatial_config() -> dict:
    with open(os.path.join(REPO, "configs", "kitti-planeseg-spatial.json")) as f:
        return json.load(f)


def select_warp(modules: list[dict]) -> list[dict]:
    """`modules` with the temporal vote's warp 'select' (the spatial mode's)
    at the same max_warp_y: the full-frame reference of a spatial run."""
    return [{**m, "warp_mode": "select", "max_warp_y": m.get("max_warp_y", 32)}
            if m["type"] == "superpixel_disparity_planeseg" else m for m in modules]


def spatial_system_phase(frames, intrinsics, dev, tag, plan) -> dict:
    """configs/kitti-planeseg-spatial.json as written (8 row shards on this
    one card, histogram-peak provider) through build_system for
    SPATIAL_SYSTEM_FRAMES frames at max_in_flight=SYSTEM_DEPTH, frame 64 the
    reset: captured (SpatialPipeline.captured_step, a graph a variant) with
    every key fetched and with the host keys; eager (module_timing: one
    spatial_step a frame), every key; and the full-frame System of the same
    modules with the 'select' warp, captured, every key.  Every fetched
    output of every frame of the captured runs must be array_equal to both
    references and the final state to the eager one; each graph's launches
    those of one eager frame of its variant (K5 8, 14 settle sweeps, K2 8,
    K3 8 x launches(sweeps), K4 8); each run's counts its plan, no plain call;
    the step bodies captured with the collector off (run_system).  Prints the
    medians of frames 3..65, the capture seconds, the peak memory and the
    launches a frame; returns them with the captured run's last frame."""
    from cartslam_tpu_torch.kernels.relax import launches
    from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
    from cartslam_tpu_torch.sources import PreloadedSource
    from cartslam_tpu_torch.utils.memory import memory_stats

    config, n = spatial_config(), SPATIAL_SYSTEM_FRAMES
    mods, parallel = config["modules"], config["parallel"]
    runs = {}
    for mode, modules, kw in (
            ("captured", mods, dict(parallel=parallel, extra_fetch_keys=SYSTEM_KEYS)),
            ("host keys", mods, dict(parallel=parallel)),
            ("eager", mods, dict(parallel=parallel, extra_fetch_keys=SYSTEM_KEYS,
                                 module_timing=True)),
            ("full frame", select_warp(mods), dict(extra_fetch_keys=SYSTEM_KEYS))):
        label = f"spatial System {mode}"
        r = run_system(PreloadedSource(frames[:n], intrinsics=intrinsics), modules, dev, label,
                       plan["spatial_system_full" if mode == "full frame" else "spatial_system"],
                       frames=n, max_in_flight=SYSTEM_DEPTH, **kw)
        system = r.pop("system")
        pipe = system.pipeline
        if isinstance(pipe, SpatialPipeline) != (mode != "full frame") \
                or system.captured != (mode != "eager") \
                or len(r["graphs"]) != (3 if system.captured else 0):
            raise AssertionError(f"{label}: {type(pipe).__name__}, captured {system.captured}, "
                                 f"graphs {r['graphs']}")
        if mode in ("captured", "host keys"):
            if pipe.n != SHARDS:
                raise AssertionError(f"{label}: {pipe.n} shards")
            sweeps = {pipe.variant(1): 24, pipe.variant(2): 8, pipe.variant(64): 24}
            for step in pipe.captured_steps.values():
                want = {"sgm_sharded": SHARDS, "sgm_settle": SETTLE_LAUNCHES,
                        "moment_tally": SHARDS,
                        "relax": SHARDS * launches(sweeps[step.variant], 1, "frame"),
                        "vote_tally": SHARDS}
                if step.launches != want:
                    raise AssertionError(f"{label}: the graph of {step.variant} launches "
                                         f"{step.launches}, an eager frame {want}")
            r["per_graph"] = {str(v.variant): v.launches for v in pipe.captured_steps.values()}
        runs[mode] = dict(r, state=system.final_state)
        del system, pipe, r
        torch.cuda.empty_cache()
    cap, host, eager, full = (runs[m] for m in ("captured", "host keys", "eager", "full frame"))
    for fid in range(1, n + 1):
        for name, ref in (("the eager spatial System", eager),
                          ("the full-frame System ('select' warp)", full)):
            bad = _fetched_equal(cap["seen"][fid], ref["seen"][fid])
            bad += _fetched_equal(host["seen"][fid],
                                  {k: ref["seen"][fid][k] for k in host["seen"][fid]})
            if bad:
                raise AssertionError(f"spatial System frame {fid}: captured != {name} on {bad}")
    for r in (cap, host):
        _assert_state_equal(r["state"], eager["state"], "spatial System final state")
    steady = slice(1, n - 2)  # ms[j] is frame j + 2's: frames 3..65
    med = {m: float(np.median(r["ms"][steady])) for m, r in runs.items()}
    mem = memory_stats()[0]
    log(f"spatial System: {config['parallel']} of {H // SHARDS} rows on one card, {n} frames at "
        f"max_in_flight={SYSTEM_DEPTH}: captured ({len(cap['graphs'])} graphs) equal to the eager "
        f"spatial System (module_timing) and to the captured full-frame System with the 'select' "
        f"warp on every fetched output ({', '.join(sorted(cap['seen'][1]))}) of every frame, "
        f"the host-keys run too, the final state equal to the eager one; the step bodies captured "
        f"with the collector off")
    log(f"spatial System launches a frame by graph (variant: launches) {host['per_graph']}; "
        f"run counts captured {cap['counts']}, eager {eager['counts']}, full frame "
        f"{full['counts']}; no plain call")
    log(f"spatial System per-frame ms (CUDA events between frame ends, frames 3..{n - 1}): "
        f"captured host keys median {med['host keys']:.3f} (min "
        f"{min(host['ms'][steady]):.3f}, max {max(host['ms'][steady]):.3f}), every key "
        f"{med['captured']:.3f}; eager module_timing {med['eager']:.3f}; full-frame 'select' "
        f"captured every key {med['full frame']:.3f}; capture s {host['graphs']} (every key "
        f"{cap['graphs']}); peak device memory captured {host['peak']:.1f} MiB (every key "
        f"{cap['peak']:.1f}), eager {eager['peak']:.1f}; after the phase (utils/memory) "
        f"{mem['bytes_in_use'] / 2**20:.1f} MiB in use, {mem['bytes_reserved'] / 2**20:.1f} "
        f"reserved of {mem['bytes_limit'] / 2**20:.0f}  [{tag}]")
    return {"median_ms": med, "counts": host["counts"], "graphs": host["graphs"],
            "peak_mib": host["peak"], "last": cap["seen"][n], "per_graph": host["per_graph"]}


def quality_scores(out: dict, gen, frame_idx: int, num_disparities: int) -> dict:
    """scripts/eval_quality.evaluate's metrics of one frame's fetched
    outputs against the synthetic truth of frame `frame_idx` (0-based), with
    the ported utils/quality: boundary recall and under-segmentation of the
    superpixels, the flow's endpoint error inside a border strip, the plane
    labels' accuracy where the truth lies in the search range, and the
    disparity's valid share and median error."""
    from cartslam_tpu_torch.ops.planeseg import HORIZONTAL, VERTICAL
    from cartslam_tpu_torch.utils import quality

    sp, planes = out["superpixels"], out["planes"]
    h, w = planes.shape
    flow = out["optflow"].astype(np.float32) / 32.0  # S10.5 -> px
    regions = gen.ground_truth_regions(frame_idx)
    mask = np.zeros((h, w), bool)
    mask[8:-8, 12:-12] = True
    disp = out["disparity"].astype(np.float32) / 16.0
    gt_disp = gen.ground_truth_disparity(frame_idx)
    interior = np.zeros((h, w), bool)
    interior[4:-4, num_disparities + 8:-8] = True
    searchable = interior & (gt_disp >= 5.0)
    valid = disp > 0
    return {
        "disp_valid_frac": float(valid[searchable].mean()),
        "disp_med_err_px": float(np.median(np.abs(disp - gt_disp)[searchable & valid])),
        "boundary_recall": quality.boundary_recall(regions, sp),
        "underseg_error": quality.undersegmentation_error(regions, sp),
        "flow_epe_px": quality.flow_epe(flow, gen.ground_truth_flow(frame_idx), mask),
        "plane_accuracy": quality.plane_accuracy(
            planes, np.where(gt_disp >= 5.0, regions, 255),
            {gen.GT_GROUND: HORIZONTAL, gen.GT_WALL: VERTICAL}),
        "num_superpixels": int(len(np.unique(sp))),
    }


def _scores(scores: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in scores.items())


def quality_phase(gen, flagship_last: dict, spatial_last: dict, dev, tag) -> dict:
    """The full-size flagship's last frame (FRAMES) and the spatial System's
    (SPATIAL_SYSTEM_FRAMES) scored against the synthetic truth and printed;
    then tests/test_quality.py's gate: the flagship at its settings
    (QUALITY_SIZE, QUALITY_D disparities, QUALITY_FRAMES frames, 'frame'
    statistics, a static provider, scripts/eval_quality.evaluate's source)
    through the captured System on the card, its last frame scored and held
    to QUALITY_FLOORS and QUALITY_CEILINGS."""
    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.sources import SyntheticDataSource

    full = {"flagship": quality_scores(flagship_last, gen, FRAMES - 1, D),
            "spatial System": quality_scores(spatial_last, gen, SPATIAL_SYSTEM_FRAMES - 1, D)}
    for name, sc in full.items():
        log(f"quality of the full-size {name} ({H}x{W}, D={D}, histogram-peak provider) against "
            f"the synthetic truth of its last frame: {_scores(sc)}  [{tag}]")
    h, w = QUALITY_SIZE
    src = SyntheticDataSource(image_size=(h, w), num_frames=QUALITY_FRAMES, max_disparity=20,
                              baseline=2.0)
    static = {"type": "static", "horizontal_range_min": 3, "horizontal_range_max": 40,
              "vertical_range_min": -6, "vertical_range_max": 3}
    mods = [{"type": "disparity", "min_disparity": 4, "num_disparities": QUALITY_D,
             "smoothing_radius": 2, "smoothing_iterations": 1},
            {"type": "disparity_derivative"}, {"type": "depth"},
            {"type": "superpixels", "initial_iterations": 24, "iterations": 8, "block_size": 12,
             "reset_iterations": 64, "stats_refresh": "frame"},
            {"type": "optflow"},
            {"type": "superpixel_disparity_planeseg", "parameter_provider": static,
             "use_temporal_smoothing": True}]
    system = build_system(src, mods, device=dev, max_in_flight=SYSTEM_DEPTH,
                          extra_fetch_keys=("planes", "superpixels", "optflow", "disparity"))
    seen = {}
    if system.run(on_frame=lambda fid, out: seen.update({fid: out})) != QUALITY_FRAMES \
            or not system.captured or system.failed_frames:
        raise AssertionError("quality gate: the captured System run failed")
    sc = quality_scores(seen[QUALITY_FRAMES], src, QUALITY_FRAMES - 1, QUALITY_D)
    bad = [k for k, v in QUALITY_FLOORS.items() if not sc[k] >= v]
    bad += [k for k, v in QUALITY_CEILINGS.items() if not sc[k] <= v]
    if bad:
        raise AssertionError(f"quality gate: {bad} outside tests/test_quality.py's limits: {sc}")
    log(f"quality gate (tests/test_quality.py's settings: {h}x{w}, D={QUALITY_D}, "
        f"{QUALITY_FRAMES} frames, 'frame' statistics, static provider; captured System): "
        f"{_scores(sc)}; within floors {QUALITY_FLOORS} and ceilings {QUALITY_CEILINGS}  [{tag}]")
    return {**full, "gate": sc}


# ---------------------------------------------------------------- new paths
# The plane fits, the ORB features and the ZED paths: 10 frames each
# through the System on the card.
PATH_FRAMES = 10
PLANE_ATOL = 1e-4  # planes card vs CPU: float32 sums in another order
ZH, ZW = 720, 1280  # the ZED recording's geometry
FEATURE_DESC_BITS = 0.01  # share of descriptor bits card vs CPU may differ
FEATURE_LEVEL_ROWS = 0.02  # share of keypoint rows of levels 1-2 that may differ


def module_config(name: str) -> list[dict]:
    with open(os.path.join(REPO, "configs", *name.split("/"))) as f:
        data = json.load(f)
    return data["modules"] if isinstance(data, dict) else data


def _span_ms(ref, spans) -> list[tuple[float, float]]:
    return [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in spans]


def _overlap_ms(spans, others) -> float:
    """Length of the parts of `spans` that intersect the union of `others`
    (all (start_ms, end_ms))."""
    total = 0.0
    for s, e in spans:
        cut = sorted((max(s, a), min(e, b)) for a, b in others if min(e, b) > max(s, a))
        total += _union_ms((a * 1e3, b * 1e3) for a, b in cut)
    return total


def _instrument(system, replays: list, host_spans: list, process_ms: list, hm=None):
    """Record CUDA events around each replay of the captured step (the
    step's stream) and around a host module's device work (its own stream),
    and the host ms of each `process` call."""
    import contextlib
    import time

    pipe = system.pipeline
    captured = pipe.captured_step

    def captured_step(variant, keys):
        step = captured(variant, keys)

        def call():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = step()
            b.record()
            replays.append((a, b))
            return out
        return call
    if system.captured:
        pipe.captured_step = captured_step
    if hm is None:
        return
    work, process = hm.device_work, hm.process

    @contextlib.contextmanager
    def device_work(ctx):
        with work(ctx):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            host_spans.append((a, b))

    def timed_process(*args, **kw):
        t0 = time.perf_counter()
        out = process(*args, **kw)
        process_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    hm.device_work = device_work
    hm.process = timed_process


def _counts_equal(label, counts, want):
    for name, n in want.items():
        if counts[name] != (n, 0):
            raise AssertionError(f"{label}: kernel {name} (launches, plain calls) "
                                 f"{counts[name]}, expected ({n}, 0)")
    if any(p for _, p in counts.values()):
        raise AssertionError(f"{label}: a plain version ran on the card: {counts}")


def run_system(source, modules, dev, label, want, *, frames=None, hm_type=None, spans=False,
               system=None, **kw) -> dict:
    """`modules` over `source` (`frames` frames, default PATH_FRAMES)
    through build_system on the card (or the given `system`, built by the
    caller), counts from 0 just before and read
    just after, checked against `want` with no plain call; returns the
    System, every frame's fetched dict, the per-frame ms (CUDA events
    between frame ends), the counts, the peak device memory, the graphs'
    capture seconds and the host module of type `hm_type`.  With `spans`,
    also the replay and host-module spans and the host module's process ms
    (CUDA events around each replay and the module's device work: host
    work a frame that the runs without `spans` do not have)."""
    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.kernels import build

    frames = frames or PATH_FRAMES
    if system is None:
        system = build_system(source, modules, device=dev, **kw)
    hm = next((m for m in system.host_modules if isinstance(m, hm_type)), None) \
        if hm_type else None
    if hm_type is not None and hm is None:
        raise AssertionError(f"{label}: no {hm_type.__name__} in the System")
    ends, seen, replays, host_spans, process_ms = [], {}, [], [], []
    _frame_end_events(system, ends)
    gc_seen = _watch_gc(system)
    ref = torch.cuda.Event(enable_timing=True)
    if spans:
        _instrument(system, replays, host_spans, process_ms, hm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ref.record()
    build.reset_counts()
    n = system.run(on_frame=lambda fid, out: seen.update({fid: out}))
    torch.cuda.synchronize()
    counts = {c.name: (c.launches, c.plain_calls) for c in build.COUNTERS.values()}
    if n != frames or sorted(seen) != list(range(1, frames + 1)) or system.failed_frames:
        raise AssertionError(f"{label}: {n} frames, failed {system.failed_frames}")
    _counts_equal(label, counts, want)
    _gc_held(label, system, gc_seen)
    ms = [ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))]
    graphs = {str(v.variant): round(v.capture_s, 3)
              for v in getattr(system.pipeline, "captured_steps", {}).values()}
    return dict(system=system, hm=hm, seen=seen, ms=ms, counts={k: v[0] for k, v in counts.items()},
                peak=torch.cuda.max_memory_allocated(dev) / 2**20, graphs=graphs,
                replays=_span_ms(ref, replays), host_spans=_span_ms(ref, host_spans),
                process_ms=process_ms)


PATH_KERNELS = ("moment_tally", "relax_sweeps", "vote_tally")


@contextlib.contextmanager
def first_calls(by_shard: bool = False):
    """Clones of the arguments of each of K2's, K3's and K4's wrappers'
    first call outside a capture while the block runs: frame 1's inputs,
    from an eager step or a captured step's eager warm-up.  With
    `by_shard`, the first call on each thread (a spatial path's shard
    threads, parallel/group.py) at each label shape and row offset.
    Yields {name: [(args, kwargs), ...]}."""
    from cartslam_tpu_torch.kernels import relax as krelax
    from cartslam_tpu_torch.kernels import tally as ktally

    owners = {"moment_tally": ktally, "relax_sweeps": krelax, "vote_tally": ktally}
    calls, seen, orig = {}, set(), {name: getattr(mod, name) for name, mod in owners.items()}
    clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
    lock = threading.Lock()

    def recorder(name, fn):
        def call(*args, **kw):
            key = (name, threading.current_thread().name, tuple(args[0].shape),
                   kw.get("row0")) if by_shard else name
            if not torch.cuda.is_current_stream_capturing():
                with lock:
                    new = key not in seen
                    seen.add(key)
                if new:
                    calls.setdefault(name, []).append(
                        ([clone(a) for a in args], {k: clone(v) for k, v in kw.items()}))
            return fn(*args, **kw)
        return call
    for name, mod in owners.items():
        setattr(mod, name, recorder(name, orig[name]))
    try:
        yield calls
    finally:
        for name, mod in owners.items():
            setattr(mod, name, orig[name])


def check_path_kernels(label, calls, names=PATH_KERNELS) -> str:
    """K2, K3 and K4 (those of `names`) on the card against their plain
    versions on the inputs of each call first_calls recorded on a path:
    the tables and counts equal, the labels within RELAX_LABEL_BOUND.  A K2
    call that took a reduce (the spatial psum) runs again with the identity
    reduce: the int64 table and rounding step it ran, on its shard."""
    from cartslam_tpu_torch.kernels import relax as krelax
    from cartslam_tpu_torch.kernels import tally as ktally

    missing = [n for n in names if n not in calls]
    if missing:
        raise AssertionError(f"{label}: no call of {missing} was recorded")
    todo, said = {n: calls[n] for n in names}, []
    for (lab, d, num, *rest), kw in todo.get("moment_tally", ()):
        reduce = rest[0] if rest else kw.get("reduce")
        got = ktally.moment_tally(lab, d, num, None if reduce is None else (lambda t: t))
        if not torch.equal(got, ktally.moment_tally_plain(lab.reshape(-1),
                                                          d.reshape(d.shape[0], -1), num)):
            raise AssertionError(f"{label}: K2 differs from its plain version on a first "
                                 f"call's labels and data ({'x'.join(map(str, lab.shape))})")
        said.append(f"K2 ({d.shape[0]} channels, {num} labels"
                    f"{'' if reduce is None else ', int64 table'}) at "
                    f"{'x'.join(map(str, lab.shape))}")
    for args, kw in todo.get("relax_sweeps", ()):
        lab, table, data, feats, c_total, iterations, direct, diagonal = args[:8]
        prog = args[8] if len(args) > 8 else kw.get("prog")
        phases, row0 = kw.get("phases", 1), kw.get("row0", 0)
        got = krelax.relax_sweeps(*args, **kw)
        want = krelax.relax_sweeps_plain(lab, table, data, feats, c_total, iterations, direct,
                                         diagonal, prog, phases=phases, row0=row0)
        ndiff = int((got != want).sum())
        if ndiff > RELAX_LABEL_BOUND or torch.equal(got, lab):
            raise AssertionError(f"{label}: K3 ({iterations} sweeps, row0 {row0}) differs from "
                                 f"its plain version on {ndiff} pixels (bound "
                                 f"{RELAX_LABEL_BOUND}), or moved nothing")
        said.append(f"K3 ({iterations} sweeps x {phases} phase(s), "
                    f"{krelax.instantiation(feats, c_total)}, row0 {row0}: {ndiff} labels "
                    f"differ) at {'x'.join(map(str, lab.shape))}")
    for (lab, v, num, classes), _ in todo.get("vote_tally", ()):
        if not torch.equal(ktally.vote_tally(lab, v, num, classes),
                           ktally.vote_tally_plain(lab.reshape(-1), v.reshape(-1), num, classes)):
            raise AssertionError(f"{label}: K4 differs from its plain version on a first "
                                 f"call's labels and votes ({'x'.join(map(str, lab.shape))})")
        said.append(f"K4 ({num} labels, {classes} classes) at {'x'.join(map(str, lab.shape))}")
    return f"{', '.join(said)}: equal to their plain versions on their first calls' inputs"


def _watch_gc(system) -> list:
    """Records gc.isenabled() at each call of a captured System's
    Pipeline.compute_step made while a stream captures: a collection during
    a capture can destroy an earlier System's graph and invalidate it."""
    seen = []
    if system.captured:
        step = system.pipeline.compute_step

        def compute_step(*args, **kw):
            if torch.cuda.is_current_stream_capturing():
                seen.append(gc.isenabled())
            return step(*args, **kw)
        system.pipeline.compute_step = compute_step
    return seen


def _gc_held(label, system, seen) -> None:
    if system.captured and (not seen or any(seen)):
        raise AssertionError(f"{label}: the step was captured with Python's cyclic collector "
                             f"on, or not captured ({len(seen)} captured step bodies)")


def _median(xs) -> float:
    return float(np.median(xs[1:])) if len(xs) > 1 else float(xs[0])


def path_plan(sweeps: int, sgm: bool = True, vote: bool = True) -> dict:
    """K1-K4 over PATH_FRAMES frames: superpixels with 24 sweeps on frame 1
    and `sweeps` on the others (no reset within 10 frames)."""
    from cartslam_tpu_torch.kernels.relax import launches

    k3 = launches(24, 1, "frame") + (PATH_FRAMES - 1) * launches(sweeps, 1, "frame")
    return {"sgm": PATH_FRAMES if sgm else 0, "moment_tally": PATH_FRAMES, "relax": k3,
            "vote_tally": PATH_FRAMES if vote else 0, "sgm_sharded": 0}


def planes_phase(frames, intrinsics, dev, tag) -> dict:
    """configs/modules/kitti-planefit.json and kitti-planecluster.json at
    376x1248 on the synthetic frames through build_system on the card
    (captured step + the plane module on its own stream), PATH_FRAMES
    frames: every frame's fetched dict holds planes_eq; for frame 3 the
    card's planes_eq equals the port's on the CPU from the same fetched
    labels and depth (assignments equal, planes within PLANE_ATOL) and a
    second card run of the same frame gives the same result; the
    planecluster took its native route, which equals the Python route; K2
    and K3 equal to their plain versions on the inputs of their first call
    (the warm-up of frame 1's capture).
    Prints the per-frame ms, the plane module's process ms a frame and the
    share of its device span that overlapped a replay."""
    import copy

    from cartslam_tpu_torch.models.planecluster import (SuperPixelPlaneClusterModule,
                                                         _adjacency_edges, grow_clusters_python)
    from cartslam_tpu_torch.models.planefit import SuperPixelPlaneFitModule
    from cartslam_tpu_torch import native
    from cartslam_tpu_torch.runtime.module import PipelineContext
    from cartslam_tpu_torch.sources import PreloadedSource

    out = {}
    check_fid = 3
    for name, cls in (("planefit", SuperPixelPlaneFitModule),
                      ("planecluster", SuperPixelPlaneClusterModule)):
        modules = module_config(f"modules/kitti-{name}.json")
        rng_states = []
        if cls is SuperPixelPlaneFitModule:
            # Keep the sampler's state before each frame, to replay one.
            orig_process = cls.process

            def process(self, ctx, fid, *a, _p=orig_process, **kw):
                rng_states.append((fid, copy.deepcopy(self.rng)))
                return _p(self, ctx, fid, *a, **kw)
            cls.process = process
        try:
            with first_calls() as calls:
                r = run_system(PreloadedSource(frames[:PATH_FRAMES], intrinsics=intrinsics),
                               modules, dev, name, path_plan(12, vote=False), hm_type=cls,
                               spans=True)
        finally:
            if cls is SuperPixelPlaneFitModule:
                cls.process = orig_process
        kernels_note = check_path_kernels(name, calls, ("moment_tally", "relax_sweeps"))
        del calls
        hm = r["hm"]
        missing = [fid for fid, f in r["seen"].items() if "planes_eq" not in f]
        if missing:
            raise AssertionError(f"{name}: frames {missing} have no planes_eq (the host module "
                                 "failed; see the log)")
        fetched = r["seen"][check_fid]
        card = fetched["planes_eq"]
        cpu_ctx = PipelineContext(height=H, width=W, q=intrinsics.q, device="cpu")
        card_ctx = r["system"].pipeline.ctx
        replay = []
        for ctx in (cpu_ctx, card_ctx):
            mod = cls(num_labels=hm.num_labels)
            if cls is SuperPixelPlaneFitModule:
                mod.rng = copy.deepcopy(dict(rng_states)[check_fid])
            replay.append(mod.process(ctx, check_fid, {}, fetched, {})["planes_eq"])
            if cls is SuperPixelPlaneClusterModule and mod.route != "native":
                raise AssertionError(f"{name}: the {ctx.device} run took the {mod.route} route")
        on_cpu, again = replay
        for other, what in ((on_cpu, "the CPU port"), (again, "a second card run")):
            atol = PLANE_ATOL if other is on_cpu else 0.0
            if not np.array_equal(card["assignments"], other["assignments"]) or \
                    len(card["planes"]) != len(other["planes"]) or not np.allclose(
                        np.asarray(card["planes"], np.float64),
                        np.asarray(other["planes"], np.float64), rtol=0, atol=atol):
                raise AssertionError(
                    f"{name} frame {check_fid}: the card's planes_eq differs from {what}: "
                    f"{int((card['assignments'] != other['assignments']).sum())} assignments, "
                    f"{len(card['planes'])} vs {len(other['planes'])} planes")
        note = ""
        if cls is SuperPixelPlaneClusterModule:
            if hm.route != "native" or not native.available():
                raise AssertionError(f"planecluster took the {hm.route} route on the card")
            planes, npts = hm.fit(card_ctx, fetched["superpixels"], fetched["depth"])
            ok = (npts >= hm.min_points) & (np.linalg.norm(planes[:, :3], axis=-1) > 0)
            a_nat, p_nat = native.grow_clusters(hm.num_labels,
                                                _adjacency_edges(fetched["superpixels"],
                                                                 hm.num_labels),
                                                planes.astype(np.float64), ok)
            a_py, p_py = grow_clusters_python(fetched["superpixels"], planes, ok, hm.num_labels)
            if not np.array_equal(a_nat, a_py) or not np.allclose(
                    p_nat, np.asarray(p_py, np.float64), rtol=0, atol=1e-7):
                raise AssertionError("planecluster: the native route differs from the Python "
                                     "route on the card's planes")
            note = (f"; native route == Python route ({len(p_nat)} clusters, "
                    f"{int((a_nat > 0).sum())} labels)")
        # The plane module's device spans (its own stream) against the
        # replays, and the replays against those of the same step without
        # the plane module (frames 2.., frame 1 holds the captures).
        spans, replays = r["host_spans"][1:], r["replays"][1:]
        dev_ms = float(np.median([e - s for s, e in spans]))
        overlap = _overlap_ms(spans, replays) / max(sum(e - s for s, e in spans), 1e-9)
        alone = run_system(PreloadedSource(frames[:PATH_FRAMES], intrinsics=intrinsics),
                           [m for m in modules if m["type"] not in (name, "planefit_visualization")],
                           dev, f"{name} without the host module", path_plan(12, vote=False),
                           spans=True)
        replay_ms = float(np.median([e - s for s, e in replays]))
        alone_ms = float(np.median([e - s for s, e in alone["replays"][1:]]))
        err = float(np.abs(np.asarray(card["planes"], np.float64)
                           - np.asarray(on_cpu["planes"], np.float64)).max(initial=0.0))
        med = _median(r["ms"])
        out[name] = dict(ms=med, process_ms=_median(r["process_ms"]), device_span_ms=dev_ms,
                         overlap=overlap, replay_ms=replay_ms, alone_replay_ms=alone_ms,
                         alone_ms=_median(alone["ms"]), counts=r["counts"])
        del alone
        log(f"planes {name}: {PATH_FRAMES} frames at {H}x{W}, planes_eq on every frame "
            f"({len(card['planes'])} planes, {int((card['assignments'] > 0).sum())} of "
            f"{hm.num_labels} labels assigned on frame {check_fid}); frame {check_fid} equal to "
            f"the CPU port (assignments equal, planes within {err:.3g} of atol {PLANE_ATOL}) and "
            f"to a second card run{note}; launches {r['counts']}; {kernels_note}")
        log(f"planes {name} per-frame ms (CUDA events between frame ends, frames "
            f"3..{PATH_FRAMES}): median {med:.3f} (min {min(r['ms'][1:]):.3f}, max "
            f"{max(r['ms'][1:]):.3f}), {out[name]['alone_ms']:.3f} without the host module; "
            f"host module process median {out[name]['process_ms']:.3f} ms a frame; its device "
            f"span median {dev_ms:.3f} ms a frame on its own stream, {overlap:.4f} of it "
            f"overlapping a replay; replay span median {replay_ms:.3f} ms against "
            f"{alone_ms:.3f} without the host module  [{tag}]")
        del r
        torch.cuda.empty_cache()
    return out


def features_phase(frames, intrinsics, dev, tag) -> dict:
    """configs/kitti-features.json's modules (the features module, left and
    right, and its visualization) at 376x1248 through the System for
    PATH_FRAMES frames, captured and eager (module_timing), every output of
    every frame equal; a warm eager step under set_sync_debug_mode("error");
    frame 2's keypoints equal to the CPU port's at level 0 (levels 1-2: at
    most FEATURE_LEVEL_ROWS of the rows), descriptors within
    FEATURE_DESC_BITS of the bits."""
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.ops.features import level_budgets
    from cartslam_tpu_torch.runtime.loop import frame_to_device
    from cartslam_tpu_torch.sources import PreloadedSource

    modules = module_config("kitti-features.json")
    keys = ("features", "feature_descriptors")
    runs = {}
    for mode in ("eager", "captured"):
        runs[mode] = run_system(PreloadedSource(frames[:PATH_FRAMES], intrinsics=intrinsics),
                                modules, dev, f"features {mode}", {}, module_timing=mode == "eager",
                                extra_fetch_keys=keys)
    for fid in range(1, PATH_FRAMES + 1):
        bad = _fetched_equal({k: runs["captured"]["seen"][fid][k] for k in keys},
                             {k: runs["eager"]["seen"][fid][k] for k in keys})
        if bad:
            raise AssertionError(f"features frame {fid}: captured != eager on {bad}")
    # A warm eager step reads nothing back to the host.
    pipe, _ = build_pipeline(PreloadedSource(frames[:2], intrinsics=intrinsics),
                             [m for m in modules if m["type"] == "features"], device=dev)
    state, params = pipe.init_state(), pipe.device_params(pipe.init_host_params())
    for fid in (1, 2):
        frame, _ = pipe.prepare(frame_to_device(frames[fid - 1], fid, dev), params)
        torch.cuda.synchronize()
        if fid == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state, _ = pipe.compute_step(state, frame, params, pipe.variant(fid))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    cpu_pipe, _ = build_pipeline(PreloadedSource(frames[:2], intrinsics=intrinsics),
                                 [m for m in modules if m["type"] == "features"], device="cpu")
    fid = 2
    _, cpu_out = cpu_pipe.step(cpu_pipe.init_state(), frame_to_device(frames[fid - 1], fid, "cpu"),
                               cpu_pipe.init_host_params(), cpu_pipe.variant(fid))
    card = runs["captured"]["seen"][fid]
    k0 = int(level_budgets(card["features"].shape[1], 3, 1.4142135)[0])
    cf, cd = cpu_out["features"].numpy(), cpu_out["feature_descriptors"].numpy()
    gf, gd = card["features"], card["feature_descriptors"]
    if not np.array_equal(gf[:, :k0], cf[:, :k0]):
        raise AssertionError(f"features: level-0 keypoints differ card vs CPU on "
                             f"{int((gf[:, :k0] != cf[:, :k0]).any(-1).sum())} rows")
    rows = float((gf[:, k0:] != cf[:, k0:]).any(-1).mean())
    bits = int(np.unpackbits((gd ^ cd).view(np.uint8)).sum())
    if rows > FEATURE_LEVEL_ROWS or bits > FEATURE_DESC_BITS * gd.size * 32:
        raise AssertionError(f"features: card vs CPU, {rows:.4f} of the level 1-2 rows and "
                             f"{bits} descriptor bits differ")
    med = {m: _median(r["ms"]) for m, r in runs.items()}
    log(f"features: {PATH_FRAMES} frames at {H}x{W}, {card['features'].shape[1]} keypoints a "
        f"view ({int((gf[..., 2] > 0).sum())} valid on frame {fid}); captured == eager on every "
        f"output of every frame; a warm step under set_sync_debug_mode('error'); card vs CPU: "
        f"level-0 keypoints equal, {rows:.4f} of the level 1-2 rows and {bits} of {gd.size * 32} "
        f"descriptor bits differ")
    log(f"features per-frame ms (CUDA events between frame ends, frames 3..{PATH_FRAMES}): "
        f"captured median {med['captured']:.3f} (min {min(runs['captured']['ms'][1:]):.3f}); "
        f"eager module_timing median {med['eager']:.3f}  [{tag}]")
    return {"ms": med}


def write_zed_recording(path: str):
    """A 720x1280 ZED npz recording of PATH_FRAMES frames: synthetic frames and an SDK-style
    measure (minus the true disparity, inf where it is invalid: the top
    rows and 2% of the pixels), with ZED-like intrinsics (fx 700, 0.12 m
    baseline).  Returns the measure [n, H, W]."""
    from cartslam_tpu_torch.sources import SyntheticDataSource

    n = PATH_FRAMES
    gen = SyntheticDataSource(image_size=(ZH, ZW), num_frames=n, seed=1, fx=700.0,
                              baseline=0.12, max_disparity=80.0)
    rng = np.random.default_rng(1)
    left = np.empty((n, ZH, ZW, 3), np.uint8)
    right = np.empty((n, ZH, ZW, 3), np.uint8)
    measure = np.empty((n, ZH, ZW), np.float32)
    for i in range(n):
        f = gen.get_next()
        left[i], right[i] = f["left"], f["right"]
        m = -gen.ground_truth_disparity(i).astype(np.float32)
        m[m == 0] = np.inf
        m[:8] = np.inf
        m[rng.random((ZH, ZW)) < 0.02] = np.inf
        measure[i] = m
    np.savez(path, left=left, right=right, disparity=measure, fx=700.0, cx=ZW / 2, cy=ZH / 2,
             baseline=0.12)
    return measure


def zed_phase(dev, tag) -> dict:
    """A 720x1280 npz recording through configs/zed-disparity.json, the
    top-level configs/zed-planeseg.json (SGM: K1-K4) and
    configs/modules/zed-planeseg.json (zed_disparity: K2-K4) on the card,
    PATH_FRAMES frames each: zed_disparity equal to the CPU port on frame 1;
    each planeseg System captured equal to its eager (module_timing) run on
    every output of every frame; K2, K3 and K4 equal to their plain versions
    on the inputs of their first call in each planeseg's eager run (frame 1,
    at the path's label count); K1 at 720x1280 equal to its plain version
    once.  Prints the per-frame ms."""
    import tempfile

    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.kernels import sgm as ksgm
    from cartslam_tpu_torch.ops import color, stereo
    from cartslam_tpu_torch.sources import ZEDDataSource

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "rec.npz")
        measure = write_zed_recording(rec)
        src = lambda disp: {"type": "zed", "path": rec, "include_disparity": disp}

        # configs/zed-disparity.json, and its zed_disparity on the CPU.
        mods = module_config("zed-disparity.json")
        r = run_system(src(True), mods, dev, "zed-disparity", {"sgm": 0},
                       extra_fetch_keys=("disparity",))
        cpu = build_system(src(True), mods, device="cpu", max_frames=1,
                           extra_fetch_keys=("disparity",))
        seen = {}
        cpu.run(on_frame=lambda fid, o: seen.update({fid: o}))
        if not np.array_equal(r["seen"][1]["disparity"], seen[1]["disparity"]):
            raise AssertionError("zed_disparity: card != CPU port on frame 1")
        d = r["seen"][1]["disparity"]
        inv = ~np.isfinite(measure[0])
        if not (d[:8] == -32768).all():
            raise AssertionError("zed_disparity: the measure's inf rows are not -32768")
        out["zed-disparity"] = _median(r["ms"])
        log(f"zed-disparity: {PATH_FRAMES} frames at {ZH}x{ZW} from an npz recording "
            f"({inv.mean():.3f} of frame 1's measure inf); card == CPU port on frame 1; "
            f"per-frame ms median {out['zed-disparity']:.3f} (frames 3..{PATH_FRAMES})  [{tag}]")
        del r, cpu

        for label, cfg, disp, plan in (
                ("zed-planeseg", "zed-planeseg.json", False, path_plan(8)),
                ("modules/zed-planeseg", "modules/zed-planeseg.json", True,
                 path_plan(8, sgm=False))):
            mods = [m for m in module_config(cfg) if not m["type"].endswith("_visualization")]
            with first_calls() as calls:
                runs = {"eager": run_system(src(disp), mods, dev, f"{label} eager", plan,
                                            module_timing=True, extra_fetch_keys=SYSTEM_KEYS)}
            kernels_note = check_path_kernels(label, calls)
            del calls
            runs["captured"] = run_system(src(disp), mods, dev, f"{label} captured", plan,
                                          extra_fetch_keys=SYSTEM_KEYS)
            for fid in range(1, PATH_FRAMES + 1):
                bad = _fetched_equal(runs["captured"]["seen"][fid], runs["eager"]["seen"][fid])
                if bad:
                    raise AssertionError(f"{label} frame {fid}: captured != eager on {bad}")
            med = {m: _median(rr["ms"]) for m, rr in runs.items()}
            out[label] = dict(ms=med, counts=runs["captured"]["counts"])
            planes = runs["captured"]["seen"][PATH_FRAMES]["planes"]
            log(f"{label}: {PATH_FRAMES} frames at {ZH}x{ZW}, captured == eager on every output "
                f"of every frame; launches {runs['captured']['counts']}; planes on frame "
                f"{PATH_FRAMES}: {', '.join(f'{(planes == v).mean():.3f}' for v in (0, 1, 2))} "
                f"(ground / wall / unknown); {kernels_note}")
            log(f"{label} per-frame ms (frames 3..{PATH_FRAMES}): captured median "
                f"{med['captured']:.3f} (min {min(runs['captured']['ms'][1:]):.3f}); eager "
                f"module_timing median {med['eager']:.3f}  [{tag}]")
            del runs
            torch.cuda.empty_cache()

        # K1 at 720x1280 against its plain version, once.
        f = ZEDDataSource(rec).get_next()
        gl = color.bgr_to_gray(torch.from_numpy(f["left"]).to(dev))
        gr = color.bgr_to_gray(torch.from_numpy(f["right"]).to(dev))
        words = [*stereo.census_transform(gl), *stereo.census_transform(gr)]
        kw = dict(min_disparity=4, num_disparities=D, p1=10, p2=120, uniqueness=12,
                  subpixel=True, lr_check=True)
        a = ksgm.sgm_fused(*words, **kw)
        b = stereo.sgm_from_census_plain(*words, **kw)
        if not torch.equal(a, b):
            raise AssertionError(f"K1 at {ZH}x{ZW}: {int((a != b).sum())} pixels differ from "
                                 "the plain version")
        log(f"K1 sgm at {ZH}x{ZW}, D={D}: array_equal to its plain version (valid share "
            f"{float((a != stereo.DISPARITY_INVALID).float().mean()):.3f})")
        del a, b, words
        torch.cuda.empty_cache()
    return out


CLI_FRAMES = 30


# ------------------------------------------------------------- multiseq
# The multi-sequence modes: B sequences in lock-step through one pipeline
# (parallel/system.MultiSeqSystem), and sequences x spatial.
MULTISEQ_B = 8
MULTISEQ_ROUNDS = FRAMES  # 65: the initial, normal and reset variants
BLEED_ROUNDS = 12
SHIPPED_ROUNDS = 10
COMPOSED = {"mode": "spatial", "devices": 8, "sequences": 2}
COMPOSED_ROUNDS = 10
MULTISEQ_PROFILE_ROUNDS = (3, 12)
# A static provider (configs/modules/zed-planeseg.json's ranges): the
# sequences do not interact through the host params.
STATIC_PROVIDER = {"type": "static", "horizontal_range_min": 1, "horizontal_range_max": 30,
                   "vertical_range_min": -3, "vertical_range_max": 1}


@contextlib.contextmanager
def per_sequence_side_streams():
    """ShardGroup.side_stream keyed by the shard and the caller's stream, so
    each of the composed mode's sequences (each on its own stream in the
    graph, warmed up on it) forks its K5 output passes onto side streams of
    its own.  The side-stream measurement of phase (e) only."""
    from cartslam_tpu_torch.parallel.group import ShardGroup

    shared = ShardGroup.side_stream

    def side_stream(self):
        i = self._local.index
        key = (i, torch.cuda.current_stream(self.devices[i]).cuda_stream)
        if key not in self._side:
            self._side[key] = torch.cuda.Stream(device=self.devices[i])
        return self._side[key]
    ShardGroup.side_stream = side_stream
    try:
        yield
    finally:
        ShardGroup.side_stream = shared


def multiseq_frames(first: list, n: int) -> list[list]:
    """The frames of synthetic sequences 0..n-1 (seed i, the flagship's
    source parameters) preloaded in host memory; sequence 0's are `first`."""
    from concurrent.futures import ThreadPoolExecutor

    from cartslam_tpu_torch.sources import PreloadedSource, SyntheticDataSource

    def make(seed):
        return PreloadedSource.wrap(SyntheticDataSource(
            image_size=(H, W), num_frames=len(first), seed=seed, max_disparity=80.0,
            baseline=20.0)).frames
    with ThreadPoolExecutor(max_workers=n - 1) as pool:
        return [first] + list(pool.map(make, range(1, n)))


def _digests(fetched: dict, batch: int | None) -> list[dict]:
    """SHA-1 of each key's array (NaN made canonical), per sequence of a
    batched fetch (or of one fetch when batch is None): compares runs whose
    outputs are too large to keep (8 x 13 MB a round)."""
    import hashlib

    def one(x):
        if x.dtype.kind == "f":
            x = np.where(np.isnan(x), np.array(np.nan, x.dtype), x)
        h = hashlib.sha1(f"{x.shape} {x.dtype}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
        return h.hexdigest()
    if batch is None:
        return [{k: one(v) for k, v in fetched.items()}]
    return [{k: one(v[b]) for k, v in fetched.items()} for b in range(batch)]


def run_multiseq(frames_by_seq, intrinsics, modules, dev, label, want, *, rounds,
                 parallel=None, captured=True, keys=SYSTEM_KEYS, spans=False, keep=False,
                 devices=None):
    """`modules` over the sequences `frames_by_seq` (`rounds` rounds) through
    build_system with a multi-sequence parallel block (default multiseq, B =
    the sequences), on the card: counts from 0 just before the run and read
    just after, checked against `want` with no plain call.  captured=False
    runs the eager batched step (one sequence after another on one stream).
    Returns the System, each round's per-sequence digests (or, with `keep`,
    the fetched arrays), the ms a round (CUDA events between round ends), the
    counts, the peak device memory allocated and reserved (the B branches'
    intermediates stay reserved apart, since each stream reuses only its own
    blocks), the capture seconds by variant and, with `spans`, the replays'
    spans (CUDA events around each replay).  `devices`: the MultiSeqSystem's
    device list (its partitions), built over build_pipeline's pipeline."""
    from cartslam_tpu_torch.config import build_pipeline, build_system
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.parallel.system import MultiSeqSystem
    from cartslam_tpu_torch.sources import PreloadedSource

    srcs = [PreloadedSource(f[:rounds], intrinsics=intrinsics) for f in frames_by_seq]
    parallel = {**(parallel or {"mode": "multiseq", "batch": len(srcs)}), "sources": srcs}
    if devices is None:
        system = build_system(srcs[0], modules, device=dev, parallel=parallel,
                              extra_fetch_keys=keys, max_in_flight=SYSTEM_DEPTH)
    else:
        system = MultiSeqSystem(srcs, build_pipeline(srcs[0], modules, device=dev)[0],
                                devices=devices, extra_fetch_keys=keys,
                                max_in_flight=SYSTEM_DEPTH)
    system.captured = captured and system.captured
    ends, seen, replays = [], {}, []
    _frame_end_events(system, ends)
    gc_seen = _watch_gc(system)
    if spans:
        step_of = system._captured_step

        def captured_step(variant):
            step = step_of(variant)

            def call():
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = step()
                b.record()
                replays.append((a, b))
                return out
            return call
        system._captured_step = captured_step
    batch = len(srcs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_counts()
    n = system.run(on_frame=lambda fid, out: seen.update(
        {fid: dict(out) if keep else _digests(out, batch)}))
    torch.cuda.synchronize()
    counts = {c.name: (c.launches, c.plain_calls) for c in build.COUNTERS.values()}
    if (n != rounds * batch or sorted(seen) != list(range(1, rounds + 1))
            or system.failed_frames):
        raise AssertionError(f"{label}: {n} frames, failed {system.failed_frames}")
    _counts_equal(label, counts, want)
    _gc_held(label, system, gc_seen)
    return dict(system=system, seen=seen, counts={k: v[0] for k, v in counts.items()},
                ms=[ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))],
                peak=torch.cuda.max_memory_allocated(dev) / 2**20,
                reserved=torch.cuda.max_memory_reserved(dev) / 2**20,
                graphs={str(v.variant): round(v.capture_s, 3)
                        for v in system.captured_steps.values()},
                replays=[a.elapsed_time(b) for a, b in replays])


def _digests_equal(label, got: dict, want: dict, seqs=None) -> None:
    """Every round's per-sequence digests of `got` equal `want`'s (on the
    keys `got` fetched); `seqs`: the sequences of `want` to compare with."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: rounds {sorted(got)} vs {sorted(want)}")
    for fid in got:
        for b, g in enumerate(got[fid]):
            w = want[fid][b if seqs is None else seqs[b]]
            bad = [k for k in g if g[k] != w.get(k)]
            if bad:
                raise AssertionError(f"{label} round {fid} sequence {b}: differs on {bad}")


def multiseq_profile(frames_by_seq, intrinsics, dev, tag) -> None:
    """A fresh captured multiseq run (host keys) with rounds
    MULTISEQ_PROFILE_ROUNDS under torch.profiler: wall ms a round, device
    busy ms and idle share, device ms by kernel."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from cartslam_tpu_torch.config import build_system
    from cartslam_tpu_torch.sources import PreloadedSource

    first, last = MULTISEQ_PROFILE_ROUNDS
    srcs = [PreloadedSource(f[:last], intrinsics=intrinsics) for f in frames_by_seq]
    system = build_system(srcs[0], flagship_modules(), device=dev, max_in_flight=SYSTEM_DEPTH,
                          parallel={"mode": "multiseq", "batch": len(srcs), "sources": srcs})
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_dispatch(k):
        if k == first - 1:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif k == last:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.stop()

    _frame_end_events(system, [], on_dispatch)
    system.run()
    n = last - first + 1
    _device_report(prof, n, window["wall_ms"] / n,
                   f"multiseq (B={len(srcs)}) captured profile, per ROUND, rounds {first}..{last}",
                   tag)


def multiseq_phase(first_frames, intrinsics, dev, tag, plan, single_ms) -> dict:
    """The multi-sequence modes on the card, each gate raising:
      (a) MULTISEQ_B synthetic sequences (seeds 0..7) of the flagship for
          MULTISEQ_ROUNDS rounds: the captured MultiSeqSystem (one graph a
          variant holding the 8 sequences' steps, each on its own stream)
          equal to the eager batched step on the card (one sequence after
          another on one stream) on every fetched output of every sequence
          and round (all of the step's keys) and on the final state; a
          captured run fetching the host keys equal too, and timed;
      (b) with a static provider, BLEED_ROUNDS rounds: sequence b of the
          captured batch equal to the single-sequence captured System on
          source b, every output, for every b (no bleed between streams);
      (c) configs/synthetic-multiseq.json as written through
          read_system_config: its first SHIPPED_ROUNDS rounds on the card
          equal to the CPU port's (depth within ~3 ulp), and the final state;
      (d) K1-K4 launch B times the flagship's plan in every run of (a), with
          no plain call;
      (e) the composed mode COMPOSED on the flagship's modules,
          COMPOSED_ROUNDS rounds: captured (a graph a variant holding both
          sequences' spatial steps) equal to the eager batched step on every
          output of every round and the final state, and equal to the
          full-frame MultiSeqSystem (warp 'select') on the same sources, every
          output (a single-sequence System's provider sees one histogram, not
          the batch's sum); K2, K3 and K4 equal to their plain versions
          on the inputs of their first call on each shard thread at each
          shape (frame 1's, and frame 2's narrower halos); the ms a round
          and the replay span with the host keys, with K5's side streams
          shared by the sequences (as shipped) and per sequence.
    Every captured run (here and in run_system) was captured with Python's
    cyclic collector off (_watch_gc).
    `single_ms`: the single-sequence captured System's ms a frame (host
    keys) from this call.  Returns the host-key run's counts and times."""
    import time

    from cartslam_tpu_torch.config import read_system_config
    from cartslam_tpu_torch.kernels.relax import launches
    from cartslam_tpu_torch.parallel.system import MultiSeqSystem
    from cartslam_tpu_torch.sources import PreloadedSource

    b = MULTISEQ_B
    t0 = time.perf_counter()
    frames = multiseq_frames(first_frames[:MULTISEQ_ROUNDS], b)
    log(f"multiseq: {b} synthetic sequences (seeds 0..{b - 1}) of {MULTISEQ_ROUNDS} frames at "
        f"{H}x{W} preloaded in {time.perf_counter() - t0:.1f} s")
    want = {k: b * n for k, n in plan["flagship"].items()}
    mods = flagship_modules()
    label = f"multiseq (B={b})"

    # (a) + (d): eager batched step, captured (every key), captured (host keys)
    runs = {}
    for mode, captured, keys in (("eager", False, SYSTEM_KEYS), ("captured", True, SYSTEM_KEYS),
                                 ("host keys", True, ())):
        r = run_multiseq(frames, intrinsics, mods, dev, f"{label} {mode}", want,
                         rounds=MULTISEQ_ROUNDS, captured=captured, keys=keys)
        system = r.pop("system")
        if not isinstance(system, MultiSeqSystem) or system.captured != captured:
            raise AssertionError(f"{label} {mode}: {type(system).__name__}, captured "
                                 f"{system.captured}")
        runs[mode] = dict(r, state=system.final_state)
        del system
        torch.cuda.empty_cache()
    eager, cap, host = runs["eager"], runs["captured"], runs["host keys"]
    _digests_equal(f"{label} captured vs eager", cap["seen"], eager["seen"])
    _digests_equal(f"{label} host keys vs eager", host["seen"], eager["seen"])
    for r in (cap, host):
        _assert_state_equal(r["state"], eager["state"], f"{label} final state")
    keys_fetched = sorted(cap["seen"][1][0])
    log(f"{label} (a): {MULTISEQ_ROUNDS} rounds at max_in_flight={SYSTEM_DEPTH}, the captured "
        f"MultiSeqSystem equal to the eager batched step on the card on every fetched output "
        f"({', '.join(keys_fetched)}) of every sequence and round and on the final state "
        f"(batch-leading); the host-keys run too")
    log(f"{label} (d): launches eager {eager['counts']}, captured {cap['counts']}, host keys "
        f"{host['counts']}: K1-K4 {b} x the flagship's plan {plan['flagship']}, no plain call")
    med = float(np.median(host["ms"][1:]))
    log(f"{label} ms a round (CUDA events between round ends, rounds 3..{MULTISEQ_ROUNDS}, host "
        f"keys): median {med:.3f} (min {min(host['ms'][1:]):.3f}, max "
        f"{max(host['ms'][1:]):.3f}); every key {float(np.median(cap['ms'][1:])):.3f}; eager "
        f"batched step {float(np.median(eager['ms'][1:])):.3f}; frames/s {b * 1000 / med:.1f} "
        f"against the single-sequence captured System's {1000 / single_ms:.1f} ({single_ms:.3f} "
        f"ms a frame, this call)  [{tag}]")
    log(f"{label} graphs (variant: capture s) {host['graphs']}; peak device memory allocated "
        f"/ reserved {host['peak']:.1f} / {host['reserved']:.1f} MiB (host keys), "
        f"{cap['peak']:.1f} / {cap['reserved']:.1f} MiB (every key), eager {eager['peak']:.1f} "
        f"/ {eager['reserved']:.1f} MiB  [{tag}]")
    out = {"counts": host["counts"], "ms": med, "fps": b * 1000 / med,
           "graphs": host["graphs"], "peak": host["peak"], "reserved": host["reserved"]}
    del runs, eager, cap
    torch.cuda.empty_cache()

    # (b) no bleed between the streams: a static provider, batch vs singles
    static = [{**m, "parameter_provider": STATIC_PROVIDER}
              if m["type"] == "superpixel_disparity_planeseg" else m for m in mods]
    k3 = launches(24, 1, "frame") + (BLEED_ROUNDS - 1) * launches(8, 1, "frame")
    one = {"sgm": BLEED_ROUNDS, "moment_tally": BLEED_ROUNDS, "relax": k3,
           "vote_tally": BLEED_ROUNDS}
    batch = run_multiseq(frames, intrinsics, static, dev, f"{label} static",
                         {k: b * n for k, n in one.items()}, rounds=BLEED_ROUNDS, spans=True)
    del batch["system"]
    torch.cuda.empty_cache()
    single_replays = []
    for s in range(b):
        r = run_system(PreloadedSource(frames[s][:BLEED_ROUNDS], intrinsics=intrinsics), static,
                       dev, f"{label} single sequence {s}", one, frames=BLEED_ROUNDS, spans=True,
                       extra_fetch_keys=SYSTEM_KEYS, max_in_flight=SYSTEM_DEPTH)
        _digests_equal(f"{label} (b) sequence {s} vs the single-sequence System",
                       {fid: _digests(v, None) for fid, v in r["seen"].items()},
                       batch["seen"], seqs=[s])
        single_replays += [e - a for a, e in r["replays"][2:]]
        del r
        torch.cuda.empty_cache()
    bspan, sspan = float(np.median(batch["replays"][2:])), float(np.median(single_replays))
    out.update(batch_replay_ms=bspan, single_replay_ms=sspan)
    log(f"{label} (b): static provider, {BLEED_ROUNDS} rounds: sequence b of the captured batch "
        f"equal to the single-sequence captured System on source b, every output, for b = "
        f"0..{b - 1}; replay span (rounds 3..{BLEED_ROUNDS}, median) batched {bspan:.3f} ms "
        f"against {b} x the single replay's {sspan:.3f} = {b * sspan:.3f} ms (ratio "
        f"{bspan / (b * sspan):.3f})  [{tag}]")

    # (c) the shipped config as written, card against the CPU port
    cfg = os.path.join(REPO, "configs", "synthetic-multiseq.json")
    shipped = {}
    for device in ("cpu", dev):
        system = read_system_config(cfg, device=device, max_frames=SHIPPED_ROUNDS,
                                    extra_fetch_keys=SYSTEM_KEYS)
        if not isinstance(system, MultiSeqSystem) or system.batch != 8:
            raise AssertionError(f"{cfg}: {type(system).__name__}")
        seen = {}
        n = system.run(on_frame=lambda fid, o: seen.update({fid: dict(o)}))
        if n != SHIPPED_ROUNDS * system.batch or system.failed_frames:
            raise AssertionError(f"{cfg} on {device}: {n} frames, failed {system.failed_frames}")
        shipped[str(device)] = (seen, system.final_state, system.captured)
        del system
    (cpu_seen, cpu_state, _), (dev_seen, dev_state, dev_captured) = shipped["cpu"], \
        shipped[str(dev)]
    if not dev_captured:
        raise AssertionError(f"{cfg}: the card's run was not captured")
    for fid in range(1, SHIPPED_ROUNDS + 1):
        _assert_equal_trees(dev_seen[fid], cpu_seen[fid], f"{cfg} round {fid}")
    _assert_equal_trees(dev_state, cpu_state, f"{cfg} final state")
    log(f"{label} (c): configs/synthetic-multiseq.json as written (8 sequences at 96x320) "
        f"through read_system_config: rounds 1..{SHIPPED_ROUNDS} of the captured card run equal "
        f"to the CPU port's MultiSeqSystem on every fetched output (depth within ~3 ulp) and the "
        f"final state")
    del shipped

    # (e) sequences x spatial
    out.update(composed_phase(frames[:COMPOSED["sequences"]], intrinsics, dev, tag))
    multiseq_profile(frames, intrinsics, dev, tag)
    return out


def composed_phase(frames, intrinsics, dev, tag) -> dict:
    """Phase (e) of multiseq_phase: the composed mode COMPOSED over the
    sequences `frames` (one list of frames each), COMPOSED_ROUNDS rounds:
    captured (each sequence on its stream, the shards' K5 side streams
    shared by the sequences) against eager and against the full-frame
    MultiSeqSystem of the same sources (warp 'select'; the provider fed the
    same batch-summed histograms); the host keys timed with K5's side
    streams shared (as shipped) and per sequence."""
    from cartslam_tpu_torch.kernels.relax import launches
    from cartslam_tpu_torch.parallel.system import SpatialMultiSeqSystem

    mods = flagship_modules()
    seqs, shards = COMPOSED["sequences"], COMPOSED["devices"] // COMPOSED["sequences"]
    sp = launches(24, 1, "frame") + (COMPOSED_ROUNDS - 1) * launches(8, 1, "frame")
    cplan = {"sgm": 0, "sgm_sharded": seqs * shards * COMPOSED_ROUNDS,
             "sgm_settle": seqs * 2 * (shards - 1) * COMPOSED_ROUNDS,
             "moment_tally": seqs * shards * COMPOSED_ROUNDS, "relax": seqs * shards * sp,
             "vote_tally": seqs * shards * COMPOSED_ROUNDS}
    label = f"composed {COMPOSED}"
    comp = {}

    def run(mode, **kw):
        r = run_multiseq(frames, intrinsics, mods, dev, f"{label} {mode}", cplan,
                         rounds=COMPOSED_ROUNDS, parallel=COMPOSED, **kw)
        system = r.pop("system")
        if not isinstance(system, SpatialMultiSeqSystem) or system.pipeline.n != shards \
                or system.captured != (mode != "eager") \
                or len(r["graphs"]) != (2 if system.captured else 0):
            raise AssertionError(f"{label} {mode}: {type(system).__name__} with "
                                 f"{system.pipeline.n} shards, captured {system.captured}, "
                                 f"graphs {r['graphs']}")
        comp[mode] = dict(r, state=system.final_state)
        del system, r
        torch.cuda.empty_cache()

    with first_calls(by_shard=True) as calls:
        run("captured", keep=True)
    kernels_note = check_path_kernels(label, calls)
    del calls
    run("eager", keep=True, captured=False)
    run("host keys", keys=(), spans=True)
    with per_sequence_side_streams():
        run("per-sequence side streams", keys=(), spans=True)
    cap, eager = comp["captured"], comp["eager"]
    for fid in range(1, COMPOSED_ROUNDS + 1):
        bad = _fetched_equal(cap["seen"][fid], eager["seen"][fid])
        if bad:
            raise AssertionError(f"{label} round {fid}: captured != eager on {bad}")
    eager_digests = {fid: _digests(v, seqs) for fid, v in eager["seen"].items()}
    for mode in ("host keys", "per-sequence side streams"):
        _digests_equal(f"{label} {mode} vs eager", comp[mode]["seen"], eager_digests)
    for mode in ("captured", "host keys", "per-sequence side streams"):
        _assert_state_equal(comp[mode]["state"], eager["state"], f"{label} {mode} final state")
    # The full-frame reference is the multiseq System over the same sources:
    # its provider is fed the same batch-summed histograms (a single System's
    # would differ from round 1 + SYSTEM_DEPTH on).
    full = {"sgm": seqs * COMPOSED_ROUNDS, "moment_tally": seqs * COMPOSED_ROUNDS,
            "relax": seqs * sp, "vote_tally": seqs * COMPOSED_ROUNDS}
    ref = run_multiseq(frames, intrinsics, select_warp(mods), dev, f"{label} full frame", full,
                       rounds=COMPOSED_ROUNDS, keep=True)
    del ref["system"]
    for fid in range(1, COMPOSED_ROUNDS + 1):
        bad = _fetched_equal(cap["seen"][fid], ref["seen"][fid])
        if bad:
            raise AssertionError(f"{label} round {fid}: differs from the full frame on {bad}")
    del ref
    med = {m: float(np.median(r["ms"][1:])) for m, r in comp.items()}
    alt = "per-sequence side streams"
    span = {m: float(np.median(comp[m]["replays"][2:])) for m in ("host keys", alt)}
    out = dict(composed_ms=med["host keys"], composed_eager_ms=med["eager"],
               composed_alt_ms=med[alt], composed_counts=comp["host keys"]["counts"],
               composed_graphs=comp["host keys"]["graphs"], composed_span=span["host keys"],
               composed_alt_span=span[alt])
    log(f"{label} (e): {seqs} sequences x {shards} row shards of {H // shards} rows on one card, "
        f"{COMPOSED_ROUNDS} rounds of the flagship: captured ({len(cap['graphs'])} graphs) equal "
        f"to the eager batched step on every output of every round "
        f"({', '.join(sorted(cap['seen'][1]))}) and the final state, and to the full-frame "
        f"MultiSeqSystem (warp 'select') on the same sources; launches "
        f"{comp['host keys']['counts']}, no plain call")
    log(f"{label} (e) ms a round (CUDA events between round ends, rounds 3..{COMPOSED_ROUNDS}): "
        f"captured host keys median {med['host keys']:.3f} (replay span {span['host keys']:.3f}), "
        f"with K5's side streams per sequence {med[alt]:.3f} (replay span {span[alt]:.3f}); "
        f"captured every key {med['captured']:.3f}; eager {med['eager']:.3f}; capture s "
        f"{comp['host keys']['graphs']}; peak {comp['host keys']['peak']:.1f} MiB (per-sequence "
        f"side streams {comp[alt]['peak']:.1f})  [{tag}]")
    log(f"{label} (e): {kernels_note}")
    del comp, cap, eager
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ multicard
# The multi-card and multi-host modes (phase 4f): partitions of the
# multi-sequence batch, processes sharing the card, the spatial mode's
# per-shard streams, the cross-card runs where there are cards for them,
# the width-sharded stencils and the SpatialFlagship preset.
MULTICARD_B = 8
MULTICARD_ROUNDS = 10
MULTIHOST_PROCS = 2
MULTIHOST_CLI_FRAMES = 5
PRESET_FRAMES = 4
CHILD_TIMEOUT_S = 300
GLOO_TIMEOUT_S = 120


def rounds_plan(rounds: int, sequences: int = 1) -> dict:
    """K1-K4 of `sequences` flagship sequences over `rounds` rounds (24
    sweeps on round 1, 8 after, no reset)."""
    from cartslam_tpu_torch.kernels.relax import launches

    k3 = launches(24, 1, "frame") + (rounds - 1) * launches(8, 1, "frame")
    return {k: sequences * n for k, n in
            {"sgm": rounds, "moment_tally": rounds, "relax": k3, "vote_tally": rounds}.items()}


def _flat_numpy(tree, path="") -> dict:
    """A tree of tensors or arrays as {path: host array}."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_numpy(tree[k], f"{path}/{k}"))
        return out
    return {path: tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _tree_digests(tree: dict, batch: int) -> list[dict]:
    """Per sequence of a batch-leading tree: SHA-1 of each leaf's slice,
    keyed by its path."""
    return _digests(_flat_numpy(tree), batch)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _provider_ranges(system) -> list:
    p = next(m for m in system.pipeline.modules if m.host_fetch_reduce()).host_state()
    return [np.asarray(p["h_range"]).tolist(), np.asarray(p["v_range"]).tolist()]


def multihost_config(path: str, port: int, rounds: int) -> None:
    """The flagship's multi-sequence config with a "multihost" block for
    MULTIHOST_PROCS processes on localhost (each process's id from
    JAX_PROCESS_ID, or its own override)."""
    with open(path, "w") as f:
        json.dump({"data_source": {"type": "synthetic", "image_size": [H, W],
                                   "num_frames": rounds},
                   "modules": flagship_modules(),
                   "parallel": {"mode": "multiseq", "batch": MULTICARD_B,
                                "multihost": {"coordinator": f"localhost:{port}",
                                              "num_processes": MULTIHOST_PROCS,
                                              "timeout": GLOO_TIMEOUT_S}}}, f)


def multihost_child(args: dict) -> int:
    """One process of the multi-host run (``chip_smoke.py --multihost-child
    ARGS``): its share of the MULTICARD_B flagship sequences (seeds as
    multiseq_frames', preloaded) through read_system_config with the
    config's "multihost" block, on card 0; writes each round's
    per-sequence digests, the final state's, the ms a round (CUDA events
    between round ends), the counts and the provider's ranges as JSON."""
    sys.path.insert(0, REPO)
    from cartslam_tpu_torch.config import read_system_config
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.sources import PreloadedSource, SyntheticDataSource

    dev = torch.device("cuda", 0)
    with open(args["config"]) as f:
        cfg = json.load(f)
    rounds, pid = cfg["data_source"]["num_frames"], args["pid"]
    parallel = dict(cfg["parallel"])
    parallel["multihost"] = dict(parallel["multihost"], process_id=pid)
    n = MULTICARD_B // MULTIHOST_PROCS
    share = range(pid * n, (pid + 1) * n)
    seqs = [PreloadedSource.wrap(SyntheticDataSource(
        image_size=(H, W), num_frames=rounds, seed=j, max_disparity=80.0, baseline=20.0))
        for j in share]
    out = {}
    for mode, keys in (("every key", SYSTEM_KEYS), ("host keys", ())):
        srcs = [PreloadedSource(q.frames, intrinsics=q.get_camera_intrinsics()) for q in seqs]
        parallel["sources"] = [srcs[j - share.start] if j in share else cfg["data_source"]
                               for j in range(MULTICARD_B)]
        system = read_system_config(args["config"], source=srcs[0], device=dev,
                                    parallel=parallel, extra_fetch_keys=keys,
                                    max_in_flight=SYSTEM_DEPTH)
        ends, seen = [], {}
        _frame_end_events(system, ends)
        build.reset_counts()
        done = system.run(on_frame=lambda fid, o: seen.update({fid: _digests(o, system.batch)}))
        torch.cuda.synchronize()
        out[mode] = {"n": done, "first": system.first, "batch": system.batch,
                     "process_count": system.process_count, "captured": system.captured,
                     "failed": system.failed_frames, "seen": seen,
                     "state": _tree_digests(system.final_state, system.batch),
                     "ms": [ends[i - 1].elapsed_time(ends[i]) for i in range(1, len(ends))],
                     "counts": {c.name: [c.launches, c.plain_calls]
                                for c in build.COUNTERS.values()},
                     "provider": _provider_ranges(system)}
        del system
    with open(args["out"], "w") as f:
        json.dump(out, f)
    return 0


def _spawn(commands: list, envs: list, cwd: str) -> list[str]:
    """The commands as processes side by side, each killed if it outlives
    CHILD_TIMEOUT_S; every one must exit with 0.  Returns their outputs."""
    procs = [subprocess.Popen(c, env=e, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c, e in zip(commands, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for k, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"process {k} of {commands[k][1:3]} exited with "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return outs


def multihost_phase(ref: dict, tag) -> dict:
    """(b): MULTIHOST_PROCS processes on this one card (``--multihost-child``),
    each with its share of the batch: every round's digests and the final
    state equal the one-process run `ref` for the same global sequences,
    the provider's ranges equal on every process (and to `ref`'s), each
    process's counts its share of the plan; then the CLI, two processes of
    ``python -m cartslam_tpu_torch CONFIG --max-frames 5``, each exiting
    with 0."""
    import tempfile

    r = MULTICARD_ROUNDS
    n = MULTICARD_B // MULTIHOST_PROCS
    want = rounds_plan(r, n)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "multihost.json")
        multihost_config(cfg, _free_port(), r)
        env = dict(os.environ, OMP_NUM_THREADS="4")
        args = [{"config": cfg, "pid": pid, "out": os.path.join(tmp, f"p{pid}.json")}
                for pid in range(MULTIHOST_PROCS)]
        _spawn([[sys.executable, os.path.join(REPO, "chip_smoke.py"), "--multihost-child",
                 json.dumps(a)] for a in args], [env] * MULTIHOST_PROCS, tmp)
        runs = []
        for a in args:
            with open(a["out"]) as f:
                runs.append(json.load(f))
        for mode in ("every key", "host keys"):
            procs = [p[mode] for p in runs]
            ranges = {json.dumps(p["provider"]) for p in procs}
            for pid, p in enumerate(procs):
                label = f"multihost process {pid} ({mode})"
                got = {k: p[k] for k in ("first", "batch", "process_count", "n", "failed")}
                if got != dict(first=pid * n, batch=n, process_count=MULTIHOST_PROCS, n=r * n,
                               failed=[]) or not p["captured"]:
                    raise AssertionError(f"{label}: {got}, captured {p['captured']}")
                _counts_equal(label, {k: tuple(v) for k, v in p["counts"].items()}, want)
                seen = {int(fid): v for fid, v in p["seen"].items()}
                _digests_equal(f"{label} vs the one-process MultiSeqSystem", seen, ref["seen"],
                               seqs=list(range(pid * n, (pid + 1) * n)))
                if p["state"] != ref["state_digests"][pid * n:(pid + 1) * n]:
                    raise AssertionError(f"{label}: the final state differs from the "
                                         "one-process run's")
            if ranges != {json.dumps(ref["provider"])}:
                raise AssertionError(f"multihost ({mode}): provider ranges {ranges}, one "
                                     f"process {ref['provider']}")
            ms = [float(np.median(p["ms"][1:])) for p in procs]
            out[mode] = dict(ms=ms, fps=[n * 1000 / m for m in ms])
        out["counts"] = [{k: v[0] for k, v in p["host keys"]["counts"].items()} for p in runs]
        log(f"multicard (b): {MULTIHOST_PROCS} processes on this one card through "
            f"read_system_config's \"multihost\" block (gloo on localhost), B={MULTICARD_B} "
            f"({n} sequences each), {r} rounds, captured, every key and host keys: every fetched "
            f"output of every round and the final state equal to the one-process "
            f"MultiSeqSystem's for the same global sequences; provider ranges "
            f"{runs[0]['host keys']['provider']} on every process and in the one-process run; "
            f"launches a run {out['counts']}, no plain call")
        for mode, one in (("host keys", ref["host_ms"]), ("every key", ref["ms"])):
            ms, fps = out[mode]["ms"], out[mode]["fps"]
            log(f"multicard (b) ms a round (CUDA events between round ends, rounds 3..{r}, "
                f"{mode}): " + ", ".join(f"process {k} {m:.3f} ({f:.1f} frames/s)"
                                         for k, (m, f) in enumerate(zip(ms, fps)))
                + f"; {sum(fps):.1f} frames/s in total against the one-process "
                f"B={MULTICARD_B} run's {MULTICARD_B * 1000 / one:.1f} ({one:.3f} ms a round, "
                f"this call)  [{tag}]")

        multihost_config(cfg, _free_port(), MULTIHOST_CLI_FRAMES)
        cli = [sys.executable, "-m", "cartslam_tpu_torch", cfg, "--max-frames",
               str(MULTIHOST_CLI_FRAMES)]
        envs = [dict(env, JAX_PROCESS_ID=str(pid), PYTHONPATH=REPO)
                for pid in range(MULTIHOST_PROCS)]
        _spawn([cli] * MULTIHOST_PROCS, envs, tmp)
        log(f"multicard (b): the CLI, {MULTIHOST_PROCS} processes of python -m "
            f"cartslam_tpu_torch <multiseq config with a multihost block> --max-frames "
            f"{MULTIHOST_CLI_FRAMES} (process id from JAX_PROCESS_ID): each exited with 0")
    return out


def width_stencils_phase(dev, cards=None) -> None:
    """(e): the width-sharded stencils (parallel/spatial.py) at H x W on
    SHARDS shards of this card, shared and per-shard streams (and, given
    `cards`, with the shards on those cards), array_equal to the unsharded
    ops: the derivative and its psum'd histogram, the interpolation (radius
    3, 2 iterations), the classification."""
    from cartslam_tpu_torch.ops import derivative as dops
    from cartslam_tpu_torch.ops import disparity as dsp
    from cartslam_tpu_torch.ops import planeseg as pops
    from cartslam_tpu_torch.parallel import spatial
    from cartslam_tpu_torch.parallel.group import ShardGroup

    gen = torch.Generator(device="cpu").manual_seed(0)
    d = (torch.randint(4, 160, (H, W), generator=gen) * 16).to(torch.int16)
    d[torch.rand(H, W, generator=gen) < 0.2] = -32768
    d = d.to(dev)
    ranges = torch.tensor([[5, 50], [-10, 5]], dtype=torch.int32, device=dev)
    kw = dict(radius=3, iterations=2, min_disparity=16, max_disparity=160 * 16)
    want_deriv, want_hist = dops.directional_derivatives(d)
    want = (want_deriv, want_hist, dsp.interpolate(d, **kw), pops.classify(want_deriv[..., 0],
                                                                           ranges))
    groups = {f"{streams} streams": ShardGroup(SHARDS, [dev] * SHARDS, streams=streams)
              for streams in ("shared", "per_shard")}
    if cards:
        groups[f"across {len(cards)} cards"] = ShardGroup(
            SHARDS, [cards[i * len(cards) // SHARDS] for i in range(SHARDS)])
    for name, group in groups.items():
        deriv, hist = spatial.sharded_derivative(group)(d)
        got = (deriv, hist, spatial.sharded_interpolate(group, **kw)(d),
               spatial.sharded_classify(group)(want_deriv[..., 0], ranges))
        torch.cuda.synchronize()
        bad = [name for name, a, b in zip(("derivatives", "histogram", "interpolate", "classify"),
                                          got, want) if not _same(a, b)]
        if bad:
            raise AssertionError(f"multicard (e) {name}: {bad} differ from the unsharded ops")
    log(f"multicard (e): the width-sharded stencils at {H}x{W} on {SHARDS} shards of "
        f"{W // SHARDS} columns ({', '.join(groups)}) array_equal to the unsharded ops: "
        f"directional_derivatives with its psum'd histogram, interpolate ({kw}), classify")


def preset_phase(frames, intrinsics, dev) -> dict:
    """(f): the SpatialFlagship preset at the flagship's knobs (SHARDS
    shards, the static provider's ranges), its captured steps (make_step
    'initial', then 'normal') over PRESET_FRAMES frames, every output and
    the state equal to the config-built SpatialPipeline of the same modules
    (its eager steps); the preset's launches counted."""
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.kernels.relax import launches
    from cartslam_tpu_torch.parallel.spatial_flagship import (SpatialFlagship,
                                                              SpatialFlagshipConfig)
    from cartslam_tpu_torch.sources import PreloadedSource

    cfg = SpatialFlagshipConfig(height=H, width=W)
    p = STATIC_PROVIDER
    ranges = ((p["horizontal_range_min"], p["horizontal_range_max"]),
              (p["vertical_range_min"], p["vertical_range_max"]))
    preset = SpatialFlagship(cfg, SHARDS, q=intrinsics.q, ranges=ranges, device=dev)
    modules = [
        {"type": "disparity", "smoothing_radius": cfg.smoothing_radius,
         "smoothing_iterations": cfg.smoothing_iterations},
        {"type": "disparity_derivative"}, {"type": "depth"}, {"type": "optflow"},
        {"type": "superpixels", "block_size": cfg.block_size, "iterations": cfg.iterations,
         "initial_iterations": cfg.initial_iterations},
        {"type": "superpixel_disparity_planeseg", "parameter_provider": STATIC_PROVIDER,
         "use_temporal_smoothing": True, "warp_mode": "select"}]
    config_pipe, _ = build_pipeline(PreloadedSource(frames[:PRESET_FRAMES],
                                                    intrinsics=intrinsics), modules, device=dev,
                                    parallel={"mode": "spatial", "devices": SHARDS})
    steps = {"initial": preset.make_step("initial"), "normal": preset.make_step("normal")}
    params = config_pipe.init_host_params()
    build.reset_counts()
    state = preset.init_state()
    got = []
    for fid, frame in enumerate(frames[:PRESET_FRAMES], start=1):
        images = {k: torch.from_numpy(frame[k]) for k in ("left", "right")}
        state, out = steps["initial" if fid == 1 else "normal"](
            state, {**images, "frame_id": fid}, preset.init_params())
        got.append({k: v.cpu().numpy() for k, v in out.items()})
    final = _flat_numpy(state)
    torch.cuda.synchronize()
    counts = {c.name: (c.launches, c.plain_calls) for c in build.COUNTERS.values()}
    sp = launches(24, 1, "frame") + (PRESET_FRAMES - 1) * launches(8, 1, "frame")
    plan = {"sgm": 0, "sgm_sharded": SHARDS * PRESET_FRAMES,
            "sgm_settle": SETTLE_LAUNCHES * PRESET_FRAMES, "moment_tally": SHARDS * PRESET_FRAMES,
            "relax": SHARDS * sp, "vote_tally": SHARDS * PRESET_FRAMES}
    _counts_equal("SpatialFlagship preset", counts, plan)
    ref_state = config_pipe.init_state()
    for fid, frame in enumerate(frames[:PRESET_FRAMES], start=1):
        images = {k: torch.from_numpy(frame[k]).to(dev) for k in ("left", "right")}
        ref_state, ref = config_pipe.step(ref_state, {**images, "frame_id": fid}, params,
                                          config_pipe.variant(fid))
        bad = _fetched_equal(got[fid - 1], {k: v.cpu().numpy() for k, v in ref.items()})
        if bad:
            raise AssertionError(f"SpatialFlagship preset frame {fid}: differs from the "
                                 f"config-built SpatialPipeline on {bad}")
    bad = _fetched_equal(final, _flat_numpy(ref_state))
    if bad:
        raise AssertionError(f"SpatialFlagship preset: the state differs on {bad}")
    log(f"multicard (f): the SpatialFlagship preset ({SHARDS} shards, {H}x{W}, "
        f"D={cfg.num_disparities}, its steps captured) equal over {PRESET_FRAMES} frames to the config-built "
        f"SpatialPipeline of the same modules on every output ({', '.join(sorted(got[0]))}) "
        f"and the state; launches {({k: v[0] for k, v in counts.items()})}")
    return {k: v[0] for k, v in counts.items()}


def per_shard_phase(frames, intrinsics, dev, tag, plan) -> dict:
    """(c): configs/kitti-planeseg-spatial.json (SHARDS shards on this card)
    through a System over a SpatialPipeline of the same modules with a
    stream per shard (the collectives as event joins), captured,
    MULTICARD_ROUNDS frames; every fetched output of every frame equal to
    the shared-stream spatial System's and to the full-frame System's (warp
    'select'); K2, K3 and K4 equal to their plain versions on their first
    calls' inputs on each shard; the ms a frame of both stream layouts."""
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.parallel.spatial_flagship import SpatialPipeline
    from cartslam_tpu_torch.runtime.system import System
    from cartslam_tpu_torch.sources import PreloadedSource

    config, n = spatial_config(), MULTICARD_ROUNDS
    mods, parallel = config["modules"], config["parallel"]
    sp = plan["spatial"]
    runs = {}

    def source():
        return PreloadedSource(frames[:n], intrinsics=intrinsics)

    def per_shard(keys):
        pipe, _ = build_pipeline(source(), mods, device=dev, parallel=parallel)
        return System(source(), SpatialPipeline(pipe.ctx, pipe.modules, pipe.n,
                                                streams="per_shard"),
                      extra_fetch_keys=keys, max_in_flight=SYSTEM_DEPTH)

    with first_calls(by_shard=True) as calls:
        runs["per-shard streams"] = run_system(
            source(), None, dev, "spatial System per-shard streams", sp, frames=n,
            system=per_shard(SYSTEM_KEYS))
    note = check_path_kernels("spatial System per-shard streams", calls)
    del calls
    runs["per-shard streams, host keys"] = run_system(
        source(), None, dev, "spatial System per-shard streams, host keys", sp, frames=n,
        system=per_shard(()))
    for keys, suffix in ((SYSTEM_KEYS, ""), ((), ", host keys")):
        runs["shared stream" + suffix] = run_system(
            source(), mods, dev, "spatial System shared stream" + suffix, sp, frames=n,
            parallel=parallel, extra_fetch_keys=keys, max_in_flight=SYSTEM_DEPTH)
    runs["full frame"] = run_system(source(), select_warp(mods), dev, "full frame 'select'",
                                    plan["full_frame_select"], frames=n,
                                    extra_fetch_keys=SYSTEM_KEYS, max_in_flight=SYSTEM_DEPTH)
    for mode, r in runs.items():
        system = r.pop("system")
        if not system.captured or (mode != "full frame" and system.pipeline.group.per_shard
                                   != mode.startswith("per-shard")):
            raise AssertionError(f"multicard (c) {mode}: captured {system.captured}")
        r["state"] = system.final_state
        del system
    ps = runs["per-shard streams"]
    for fid in range(1, n + 1):
        for mode, r in runs.items():
            bad = _fetched_equal(r["seen"][fid], {k: ps["seen"][fid][k] for k in r["seen"][fid]})
            if bad:
                raise AssertionError(f"multicard (c) frame {fid}: {mode} differs from the "
                                     f"per-shard streams' run on {bad}")
    for mode in ("shared stream", "shared stream, host keys", "per-shard streams, host keys"):
        _assert_state_equal(runs[mode]["state"], ps["state"], f"multicard (c) {mode} state")
    med = {m: float(np.median(r["ms"][1:])) for m, r in runs.items()}
    log(f"multicard (c): {config['parallel']} with a stream per shard (event joins), captured "
        f"({len(ps['graphs'])} graphs), {n} frames: every fetched output of every frame equal to "
        f"the shared-stream spatial System and to the full-frame System ('select'), the state "
        f"to the shared-stream run's; launches {ps['counts']}; {note}")
    log(f"multicard (c) ms a frame (CUDA events between frame ends, frames 3..{n}): host keys: "
        f"per-shard streams {med['per-shard streams, host keys']:.3f}, shared stream "
        f"{med['shared stream, host keys']:.3f}; every key: per-shard streams "
        f"{med['per-shard streams']:.3f}, shared stream {med['shared stream']:.3f}, full frame "
        f"{med['full frame']:.3f}; capture s {runs['per-shard streams, host keys']['graphs']} "
        f"(shared {runs['shared stream, host keys']['graphs']})  [{tag}]")
    out = {"counts": runs["per-shard streams, host keys"]["counts"], "ms": med}
    del runs, ps
    torch.cuda.empty_cache()
    return out


def cross_card_phase(frames_by_seq, intrinsics, ref, dev, tag, plan) -> str:
    """(d): with two or more cards, the spatial System with its shards on
    the visible cards (eager) equal to the full frame, the MultiSeqSystem
    over every card equal to the one-card run `ref`, and the width stencils
    across the cards; on one card, a line that says the cross-card copies
    did not run."""
    from cartslam_tpu_torch.sources import PreloadedSource

    cards = torch.cuda.device_count()
    if cards < 2:
        msg = (f"multicard (d): the cross-card copies were not run on this {cards}-card machine "
               "(they need two or more cards)")
        log(msg)
        return msg
    n = MULTICARD_ROUNDS
    config = spatial_config()
    source = PreloadedSource(frames_by_seq[0][:n], intrinsics=intrinsics)
    r = run_system(source, config["modules"], dev, "cross-card spatial", plan["spatial"],
                   frames=n, parallel=config["parallel"], extra_fetch_keys=SYSTEM_KEYS,
                   max_in_flight=SYSTEM_DEPTH)
    system = r.pop("system")
    shard_cards = sorted({str(d) for d in system.pipeline.group.devices})
    if system.captured or len(shard_cards) < 2:
        raise AssertionError(f"cross-card spatial: captured {system.captured}, cards "
                             f"{shard_cards}")
    full = run_system(PreloadedSource(frames_by_seq[0][:n], intrinsics=intrinsics),
                      select_warp(config["modules"]), dev, "cross-card full frame",
                      plan["full_frame_select"], frames=n, extra_fetch_keys=SYSTEM_KEYS,
                      max_in_flight=SYSTEM_DEPTH)
    for fid in range(1, n + 1):
        bad = _fetched_equal(r["seen"][fid], full["seen"][fid])
        if bad:
            raise AssertionError(f"cross-card spatial frame {fid}: differs on {bad}")
    ms = {}
    for mode, keys in (("every key", SYSTEM_KEYS), ("host keys", ())):
        run = run_multiseq(frames_by_seq, intrinsics, flagship_modules(), dev,
                           f"cross-card multiseq, {mode}", rounds_plan(n, MULTICARD_B), rounds=n,
                           keys=keys)
        parts = len(run.pop("system").partitions)
        if parts < 2:
            raise AssertionError("cross-card multiseq: one partition")
        _digests_equal(f"cross-card multiseq vs one card, {mode}", run["seen"], ref["seen"])
        ms[mode] = float(np.median(run["ms"][1:]))
    width_stencils_phase(dev, [torch.device("cuda", i) for i in range(cards)])
    msg = (f"multicard (d): the spatial System with its shards on cards {shard_cards} (eager) "
           f"equal to the full frame over {n} frames; the MultiSeqSystem (B={MULTICARD_B}) over "
           f"{parts} cards equal to the one-card run; ms a frame spatial, every key "
           f"{float(np.median(r['ms'][1:])):.3f}; ms a round multiseq, rounds 3..{n}: host keys "
           f"{ms['host keys']:.3f} ({ref['host_ms']:.3f} on one card), every key "
           f"{ms['every key']:.3f} ({ref['ms']:.3f})  [{tag}]")
    log(msg)
    return msg


def cross_card_main() -> int:
    """``python3 chip_smoke.py --cross-card``: on a machine with two or more
    cards, phase 4f (d) alone (the other phases assume one visible card):
    the kernels built, the MultiSeqSystem on card 0 as the reference, then
    cross_card_phase; the result line as main's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --cross-card: needs two or more CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cartslam_tpu_torch.kernels import build
    from cartslam_tpu_torch.sources import PreloadedSource, SyntheticDataSource

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()
    log("; ".join(card))
    tag = f"{torch.cuda.get_device_name(0)} x {len(card)}, {card[0].split(',')[-1].strip()}"
    build.build()
    build.library()
    r = MULTICARD_ROUNDS
    source = PreloadedSource.wrap(SyntheticDataSource(image_size=(H, W), num_frames=r, seed=0,
                                                      max_disparity=80.0, baseline=20.0))
    intrinsics = source.get_camera_intrinsics()
    frames = multiseq_frames(source.frames, MULTICARD_B)
    ref = {}
    for mode, keys in (("ms", SYSTEM_KEYS), ("host_ms", ())):
        run = run_multiseq(frames, intrinsics, flagship_modules(), dev, "multiseq on card 0",
                           rounds_plan(r, MULTICARD_B), rounds=r, devices=[dev], keys=keys)
        ref[mode] = float(np.median(run["ms"][1:]))
        ref.setdefault("seen", run["seen"])
        del run
    cross_card_phase(frames, intrinsics, ref, dev, tag, launch_plan())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def multicard_phase(first_frames, intrinsics, dev, tag, plan) -> dict:
    """Phase 4f, the multi-card and multi-host modes on the card, each gate
    raising:
      (a) the MultiSeqSystem (B=MULTICARD_B flagship sequences, seeds as
          multiseq_frames') with devices=["cuda:0", "cuda:0"]: two
          partitions, two graphs a variant, equal on every fetched output of
          rounds 1..MULTICARD_ROUNDS and on the final state to the
          one-partition run; the ms a round of both;
      (b) multihost_phase: two processes on this card;
      (c) per_shard_phase: the spatial System with a stream per shard;
      (d) cross_card_phase: the cross-card runs, or the line that they did
          not run on one card;
      (e) width_stencils_phase: the width-sharded stencils;
      (f) preset_phase: the SpatialFlagship preset.
    Returns the launch counts of its paths and its times."""
    import time

    r = MULTICARD_ROUNDS
    t0 = time.perf_counter()
    frames = multiseq_frames(first_frames[:r], MULTICARD_B)
    log(f"multicard: {MULTICARD_B} synthetic sequences of {r} frames preloaded in "
        f"{time.perf_counter() - t0:.1f} s")
    want = rounds_plan(r, MULTICARD_B)
    runs = {}
    for name, devices, keys in (("one partition", None, SYSTEM_KEYS),
                                ("two partitions", [dev, dev], SYSTEM_KEYS),
                                ("one partition, host keys", None, ()),
                                ("two partitions, host keys", [dev, dev], ())):
        runs[name] = run_multiseq(frames, intrinsics, flagship_modules(), dev,
                                  f"multicard (a) {name}", want, rounds=r, devices=devices,
                                  keys=keys)
        system = runs[name].pop("system")
        parts = [(p.lo, p.hi, str(p.device)) for p in system.partitions]
        if len(parts) != (2 if devices else 1) or not system.captured \
                or len(system.captured_steps) != 2 * len(parts):
            raise AssertionError(f"multicard (a) {name}: partitions {parts}, captured "
                                 f"{system.captured}, graphs {len(system.captured_steps)}")
        runs[name].update(state=_tree_digests(system.final_state, MULTICARD_B), parts=parts,
                          provider=_provider_ranges(system))
        del system
        torch.cuda.empty_cache()
    one, two = runs["one partition"], runs["two partitions"]
    _digests_equal("multicard (a) two partitions vs one", two["seen"], one["seen"])
    _digests_equal("multicard (a) two partitions vs one, host keys",
                   runs["two partitions, host keys"]["seen"], one["seen"])
    if two["state"] != one["state"] or runs["two partitions, host keys"]["state"] != one["state"]:
        raise AssertionError("multicard (a): the final state differs")
    med = {k: float(np.median(v["ms"][1:])) for k, v in runs.items()}
    log(f"multicard (a): the MultiSeqSystem (B={MULTICARD_B}) with devices [{dev}, {dev}]: "
        f"partitions {two['parts']}, two graphs a variant, equal to the one-partition run on "
        f"every fetched output of rounds 1..{r} and the final state (the host-keys runs too); "
        f"launches {two['counts']}")
    log(f"multicard (a) ms a round (CUDA events between round ends, rounds 3..{r}): host keys: "
        f"two partitions {med['two partitions, host keys']:.3f}, one partition "
        f"{med['one partition, host keys']:.3f}; every key: two partitions "
        f"{med['two partitions']:.3f}, one partition {med['one partition']:.3f}; capture s "
        f"{runs['two partitions, host keys']['graphs']} / "
        f"{runs['one partition, host keys']['graphs']}  [{tag}]")
    ref = dict(seen=one["seen"], state_digests=one["state"], provider=one["provider"],
               ms=med["one partition"], host_ms=med["one partition, host keys"])
    out = {"partitions": two["counts"], "partitions_ms": med}
    host = multihost_phase(ref, tag)
    out.update(multihost=host)
    out["per_shard"] = per_shard_phase(first_frames, intrinsics, dev, tag, plan)
    out["cross_card"] = cross_card_phase(frames, intrinsics, ref, dev, tag, plan)
    width_stencils_phase(dev)
    out["preset"] = preset_phase(first_frames, intrinsics, dev)
    del frames, runs
    torch.cuda.empty_cache()
    return out


def cli_phase() -> None:
    """The CLI: configs/synthetic-planeseg.json, then the flagship's module
    config (its two plane-segmentation visualizations) for 30 frames with
    --timing and --save-samples in a temporary directory: a timing CSV with
    the JAX columns and a PNG sample of both visualization modules at frame
    30 (the sink writes the frames with frame_id % 30 == 0)."""
    import tempfile

    from cartslam_tpu_torch.__main__ import main as cli_main

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            cfg = os.path.join(REPO, "configs", "synthetic-planeseg.json")
            if cli_main([cfg, "--device", "cuda", "--max-frames", "5"]) != 0:
                raise AssertionError("CLI run failed")
            args = [os.path.join(REPO, "configs", "sources", "synthetic.json"),
                    os.path.join(REPO, "configs", "modules", "kitti-planeseg.json"),
                    "--device", "cuda", "--max-frames", str(CLI_FRAMES), "--timing",
                    "--save-samples"]
            if cli_main(args) != 0:
                raise AssertionError("CLI run of the flagship's module config failed")
            timing = os.listdir("timing")
            with open(os.path.join("timing", timing[0])) as f:
                rows = [line.strip().split(";") for line in f]
            samples = sorted(os.listdir("samples"))
        finally:
            os.chdir(cwd)
    if rows[0] != ["name", "run_id", "time_init", "time_start", "time_end", "duration_ms"] \
            or sorted(int(r[1]) for r in rows[1:] if r[0] == "frame") != \
            list(range(1, CLI_FRAMES + 1)):
        raise AssertionError(f"CLI timing CSV: {rows[:3]}")
    want = [f"PlaneSegmentationBEVVisualization-{CLI_FRAMES:06d}.png",
            f"Plane_Segmentation-{CLI_FRAMES:06d}.png"]
    if samples != want:
        raise AssertionError(f"CLI samples {samples}, expected {want}")
    log("cli: configs/synthetic-planeseg.json --device cuda --max-frames 5 OK; "
        "configs/sources/synthetic.json configs/modules/kitti-planeseg.json --device cuda "
        f"--max-frames {CLI_FRAMES} --timing --save-samples OK: {timing[0]} with the "
        "JAX columns, "
        f"samples {samples}")


def ptxas_report(build, info) -> None:
    """Registers, static shared memory and spill bytes (ptxas -v) of K1's
    and K6's path kernels, the WTA, K3's kernels and the K2, K4 and K7
    tally kernels; fails if the flagship's instantiation of the fused relax
    kernel, or a tally kernel a path runs (K2 with 7 and 5 channels, K4,
    K7), spills."""
    import re

    kernels = build.kernel_resources(info.report.read_text())
    flagship_relax = []
    for k in kernels:
        name = k["name"]
        if not re.search(r"sgm_[hv]paths|sgm_settle|sgm_wta|relax_|moment_tally|vote_tally|"
                         r"label_tally", name):
            continue
        if re.search(r"relax_sweeps_kernel(<true>|<\(bool\)1>|ILb1E)", name):
            flagship_relax.append(k)
        if re.search(r"moment_tally_kernel<\(int\)[57]>|vote_tally_kernel|label_tally_kernel",
                     name) and (
                k["spill_stores"] or k["spill_loads"]):
            raise AssertionError(f"ptxas: the tally kernel {name} spills: {k}")
        log(f"ptxas: {name}: {k['registers']} registers, {k['smem']} bytes static smem, "
            f"{k['stack']} bytes stack, {k['spill_stores']} / {k['spill_loads']} bytes spill "
            "stores / loads")
    if len(flagship_relax) != 1 or flagship_relax[0]["spill_stores"] or \
            flagship_relax[0]["spill_loads"]:
        raise AssertionError(f"ptxas: the flagship relax kernel spills, or is missing from "
                             f"the report: {flagship_relax}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from cartslam_tpu_torch.config import build_pipeline
    from cartslam_tpu_torch.kernels import build
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
    ptxas_report(build, info)
    plan = launch_plan()

    # 3. kernels vs plain versions
    results, paths = kernel_phase(dev, tag)
    sharded_sgm_phase(dev, tag, paths, results)
    shard_kernels_phase(dev, paths)

    # 4. paths, each with its own counts
    launches = entry_point_paths(paths)
    del paths
    torch.cuda.empty_cache()
    gen = SyntheticDataSource(image_size=(H, W), num_frames=SPATIAL_SYSTEM_FRAMES, seed=0,
                              max_disparity=80.0, baseline=20.0)
    source = PreloadedSource.wrap(gen)
    intrinsics = source.get_camera_intrinsics()
    torch.cuda.reset_peak_memory_stats(dev)
    pipe, res, frame_ms, last, counts = drive(
        *build_pipeline(PreloadedSource(source.frames[:FRAMES], intrinsics=intrinsics),
                        flagship_modules(), device=dev), plan["flagship"])
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    log("flagship modules: " + " -> ".join(m.name for m in pipe.modules))
    log(f"flagship: {res.frames} frames at {H}x{W}, D={D}; launches {counts}; "
        f"peak device memory {peak_mb:.1f} MiB")
    if res.frames != FRAMES:
        raise AssertionError(f"ran {res.frames} frames, expected {FRAMES}")
    check_flagship_outputs(res, last, gen)
    for name in plan["flagship"]:
        launches[name] = counts[name]
    del pipe, res, last

    nt_source = PreloadedSource(source.frames[:NONTEMPORAL_FRAMES], intrinsics=intrinsics)
    _, nt_res, nt_ms, _, nt_counts = drive(
        *build_pipeline(nt_source, nontemporal_modules(), device=dev), plan["nontemporal"])
    log(f"non-temporal slice: {nt_res.frames} frames; launches {nt_counts}; per-frame median "
        f"{float(np.median(nt_ms[2:])):.3f} ms over frames 3..{NONTEMPORAL_FRAMES}  [{tag}]")
    faithful_ms = faithful_paths(source.frames, intrinsics, gen, dev, tag, plan)

    # 4b. the System: captured step against the eager one
    sync_free_step_check(source.frames, intrinsics, dev)
    system = {"flagship": system_phase(source.frames, intrinsics, dev, tag, plan,
                                       flagship_modules(), "temporal flagship", "flagship"),
              "faithful": system_phase(source.frames, intrinsics, dev, tag, plan,
                                       faithful_modules(), "faithful flagship", "faithful")}
    for name in plan["flagship"]:
        launches[name] = system["flagship"]["counts"][name]
    spatial_phase(source.frames, intrinsics, dev, tag, plan)
    spatial_phase(source.frames, intrinsics, dev, tag, plan, n_frames=SPATIAL_PHASE_FRAMES,
                  superpixels={"stats_refresh": "phase"},
                  keys=("spatial_phase_full", "spatial_phase"))

    # 4c. the plane fits, the ORB features and the ZED paths
    planes = planes_phase(source.frames, intrinsics, dev, tag)
    features = features_phase(source.frames, intrinsics, dev, tag)
    zed = zed_phase(dev, tag)
    by_path = {"temporal flagship (System)": system["flagship"]["counts"],
               **{f"kitti-{k}": v["counts"] for k, v in planes.items()},
               **{k: v["counts"] for k, v in zed.items() if isinstance(v, dict)}}

    # 4d. the multi-sequence modes
    multiseq = multiseq_phase(source.frames, intrinsics, dev, tag, plan,
                              system["flagship"]["median_ms"]["host keys"])
    by_path[f"multiseq (B={MULTISEQ_B})"] = multiseq["counts"]
    by_path[f"composed {COMPOSED['sequences']} x {SHARDS // COMPOSED['sequences']} shards "
            "(captured)"] = multiseq["composed_counts"]

    # 4e. the spatial System, captured against eager and the full frame
    spatial = spatial_system_phase(source.frames, intrinsics, dev, tag, plan)
    by_path[f"spatial System ({SHARDS} shards, captured)"] = spatial["counts"]

    # 4f. the multi-card and multi-host modes
    multicard = multicard_phase(source.frames, intrinsics, dev, tag, plan)
    by_path[f"multiseq 2 partitions (B={MULTICARD_B})"] = multicard["partitions"]
    for pid, c in enumerate(multicard["multihost"]["counts"]):
        by_path[f"multihost process {pid} (B={MULTICARD_B})"] = c
    by_path[f"spatial System, a stream per shard ({SHARDS} shards)"] = \
        multicard["per_shard"]["counts"]
    by_path[f"SpatialFlagship preset ({SHARDS} shards)"] = multicard["preset"]

    # 5. card against CPU
    small_temporal_check(dev)
    small_temporal_check(dev, faithful=True)
    flow_ms = full_flow_check(source.frames, dev, tag)
    quality = quality_phase(gen, system["flagship"]["last"], spatial["last"], dev, tag)

    # 6. profile
    profile_phase(source.frames, intrinsics, dev, tag)
    profile_phase(source.frames, intrinsics, dev, tag, faithful_modules(), "faithful profile")
    spatial_profile(source.frames, intrinsics, dev, tag)
    system_profile(source.frames, intrinsics, dev, tag)
    system_profile(source.frames, intrinsics, dev, tag, faithful_modules(),
                   "faithful captured profile")
    config = spatial_config()
    spatial_prof = {mode: system_profile(source.frames, intrinsics, dev, tag, config["modules"],
                                         f"spatial System {mode} profile", config["parallel"],
                                         captured=mode == "captured")
                    for mode in ("captured", "eager")}

    # 7. the CLI path
    cli_phase()

    # 8. times
    steady = frame_ms[2:]
    log(f"flagship per-frame ms: median {float(np.median(steady)):.3f} over frames 3..{FRAMES} "
        f"(min {min(steady):.3f}, max {max(steady):.3f}); frame 1 {frame_ms[0]:.3f}, "
        f"frame 64 (reset) {frame_ms[63]:.3f}; dense_flow alone {flow_ms:.3f}  [{tag}]")
    steady = faithful_ms[2:]
    log(f"faithful flagship per-frame ms: median {float(np.median(steady)):.3f} over frames "
        f"3..{FRAMES} (min {min(steady):.3f}, max {max(steady):.3f}); frame 1 "
        f"{faithful_ms[0]:.3f}, frame 64 (reset) {faithful_ms[63]:.3f}  [{tag}]")
    for name, r in system.items():
        eager = float(np.median((frame_ms if name == "flagship" else faithful_ms)[2:]))
        log(f"{name} per-frame ms, frames 3..{FRAMES}, one call: System captured "
            f"{r['median_ms']['captured']:.3f} (every key fetched) / "
            f"{r['median_ms']['host keys']:.3f} (host keys), System eager with module_timing "
            f"{r['median_ms']['eager']:.3f}, eager run loop {eager:.3f}; {len(r['graphs'])} "
            f"graphs, capture s {r['graphs']}, peak {r['peak_mib']:.1f} MiB  [{tag}]")
    for name, r in planes.items():
        log(f"kitti-{name} per-frame ms, frames 3..{PATH_FRAMES}: System captured "
            f"{r['ms']:.3f} ({r['alone_ms']:.3f} without {name}); {name} process "
            f"{r['process_ms']:.3f} ms a frame on the host, device span {r['device_span_ms']:.3f} "
            f"ms on its own stream, {r['overlap']:.4f} of it overlapping a replay; replay span "
            f"{r['replay_ms']:.3f} ms ({r['alone_replay_ms']:.3f} without {name})  [{tag}]")
    log(f"kitti-features per-frame ms, frames 3..{PATH_FRAMES}: System captured "
        f"{features['ms']['captured']:.3f}, eager module_timing {features['ms']['eager']:.3f}  "
        f"[{tag}]")
    log(f"zed-disparity per-frame ms at {ZH}x{ZW}: System captured {zed['zed-disparity']:.3f}  "
        f"[{tag}]")
    for label in ("zed-planeseg", "modules/zed-planeseg"):
        log(f"{label} per-frame ms at {ZH}x{ZW}, frames 3..{PATH_FRAMES}: System captured "
            f"{zed[label]['ms']['captured']:.3f}, eager module_timing "
            f"{zed[label]['ms']['eager']:.3f}  [{tag}]")
    log(f"multiseq (B={MULTISEQ_B}) ms a round, rounds 3..{MULTISEQ_ROUNDS}: "
        f"{multiseq['ms']:.3f} captured (host keys), {multiseq['fps']:.1f} frames/s against "
        f"{1000 / system['flagship']['median_ms']['host keys']:.1f} for the single-sequence "
        f"System; replay span {multiseq['batch_replay_ms']:.3f} against {MULTISEQ_B} x "
        f"{multiseq['single_replay_ms']:.3f}; peak allocated / reserved {multiseq['peak']:.1f} / "
        f"{multiseq['reserved']:.1f} MiB, capture s "
        f"{multiseq['graphs']}  [{tag}]")
    med, prof = spatial["median_ms"], spatial_prof
    log(f"spatial System per-frame ms, frames 3..{SPATIAL_SYSTEM_FRAMES - 1}, one call: captured "
        f"{med['host keys']:.3f} (host keys) / {med['captured']:.3f} (every key), eager "
        f"module_timing {med['eager']:.3f}; profiled frames {SYSTEM_PROFILE_FRAMES[0]}.."
        f"{SYSTEM_PROFILE_FRAMES[1]}: " + "; ".join(
            f"{m} wall {p['wall']:.3f}, busy "
            + ("not measured" if p["busy"] is None else f"{p['busy']:.3f}, idle share "
               f"{p['idle']:.4f}") for m, p in prof.items())
        + f"; {len(spatial['graphs'])} graphs, capture s {spatial['graphs']}, peak "
        f"{spatial['peak_mib']:.1f} MiB; launches a frame by graph {spatial['per_graph']}  "
        f"[{tag}]")
    log(f"composed {COMPOSED} ms a round, rounds 3..{COMPOSED_ROUNDS}: captured "
        f"{multiseq['composed_ms']:.3f} (host keys; replay span {multiseq['composed_span']:.3f}), "
        f"K5's side streams per sequence {multiseq['composed_alt_ms']:.3f} (replay span "
        f"{multiseq['composed_alt_span']:.3f}), eager {multiseq['composed_eager_ms']:.3f}; "
        f"capture s {multiseq['composed_graphs']}  [{tag}]")
    mh, pm, ps = (multicard[k] for k in ("multihost", "partitions_ms", "per_shard"))
    log(f"multicard ms a round, rounds 3..{MULTICARD_ROUNDS}, B={MULTICARD_B}, host keys: "
        f"one partition {pm['one partition, host keys']:.3f}, two partitions "
        f"{pm['two partitions, host keys']:.3f}, {MULTIHOST_PROCS} processes "
        + ", ".join(f"{m:.3f}" for m in mh["host keys"]["ms"])
        + f" ({sum(mh['host keys']['fps']):.1f} frames/s in total); spatial System ms a frame, "
        f"host keys, a stream per shard {ps['ms']['per-shard streams, host keys']:.3f}, shared "
        f"stream {ps['ms']['shared stream, host keys']:.3f}  [{tag}]")
    log(multicard["cross_card"])
    for name, sc in quality.items():
        log(f"quality {name}: {_scores(sc)}  [{tag}]")
    launches_by_path = {}
    for name in [*plan["flagship"], "sgm_sharded"]:
        launches_by_path[name] = {p: c[name] for p, c in by_path.items() if c.get(name)}
        launches[name] = sum(launches_by_path[name].values())
    for name, r in results.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), launches {launches[name]} "
            f"({KERNELS[name][2]}{': ' + str(launches_by_path[name]) if name in launches_by_path else ''})"
            f"  [{tag}]")

    kernels = []
    for name, (src, replaces, _) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches[name], **results[name]}
        if name in launches_by_path:
            entry["launches_by_path"] = launches_by_path[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--multihost-child":
        sys.exit(multihost_child(json.loads(sys.argv[2])))
    if sys.argv[1:] == ["--cross-card"]:
        sys.exit(cross_card_main())
    sys.exit(main())
