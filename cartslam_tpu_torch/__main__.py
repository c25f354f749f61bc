"""CLI: ``python -m cartslam_tpu_torch <config>`` or ``<source-config>
<modules-config>`` (the counterpart of ``python -m cartslam_tpu``).

Builds the System from the same JSON configs as the JAX CLI, with its
flags, and streams every frame through the pipeline on the chosen device
(``--device``, default ``cuda``; without a CUDA device that raises, there
is no fallback).  On the card each frame is one replay of the step's CUDA
graph for its variant; the first frame of each variant includes its
capture.  ``--timing`` writes the System's rows to timing/*.csv: the
`system` and `frame` rows, and the System's spans and device stamps
(runtime/timing.py); ``--module-timing`` runs the eager step module by
module instead, with a sync and a CSV row per module (and no spans).
``--profile DIR`` writes a torch.profiler trace of the run (the counterpart
of jax.profiler.trace); under ``--timing`` the trace holds the System's
spans as `cart.*` ranges.  The closing log line gives the System's counters
per frame (System.COUNTERS).
A multi-sequence config (``configs/synthetic-multiseq.json``) runs its B
sequences through a MultiSeqSystem, one graph replay a round on the card;
the options that mode does not take (``--module-timing``) are dropped with
the JAX warning.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cartslam_tpu_torch", description="CART-SLAM pipeline on PyTorch + CUDA"
    )
    parser.add_argument("config", nargs="+", help="config JSON (1 combined or 2 files)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--timing", action="store_true", help="write timing CSVs")
    parser.add_argument("--save-samples", action="store_true")
    parser.add_argument("--record", action="store_true")
    parser.add_argument("--show", action="store_true", help="open cv2 windows")
    parser.add_argument("--checkpoint", default=None, help="write state checkpoints here")
    parser.add_argument("--checkpoint-interval", type=int, default=100)
    parser.add_argument("--resume", default=None, help="resume from a checkpoint file")
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace of the run into DIR",
    )
    parser.add_argument(
        "--module-timing", action="store_true",
        help="per-module timing rows (eager, module-by-module execution; implies --timing)",
    )
    parser.add_argument(
        "--grayscale", action="store_true",
        help="whole-pipeline grayscale processing (CARTSLAM_IMAGE_MAKE_GRAYSCALE)",
    )
    parser.add_argument("--log-file", default="app.log")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    log_file = logging.FileHandler(args.log_file, delay=True)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(), log_file],
    )

    from .config import read_system_config
    from .runtime.timing import TimingWriter
    from .viz.ui import MultiSink, SampleSink, VideoSink, WindowViewer

    sinks = []
    viewer = None
    if args.show:
        viewer = WindowViewer()
        viewer.start()
        sinks.append(viewer)
    if args.save_samples:
        sinks.append(SampleSink())
    if args.record:
        sinks.append(VideoSink())
    sink = MultiSink(*sinks) if sinks else None
    timing = TimingWriter() if args.timing or args.module_timing else None

    try:
        system = read_system_config(
            *args.config,
            device=args.device,
            timing=timing,
            image_sink=sink,
            max_frames=args.max_frames,
            checkpoint_path=args.checkpoint,
            checkpoint_interval=args.checkpoint_interval,
            resume_from=args.resume,
            module_timing=args.module_timing,
            grayscale=args.grayscale,
        )
        if args.profile:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if system.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(args.profile, exist_ok=True)
            with profile(activities=activities) as prof:
                n = system.run()
            prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        else:
            n = system.run()
        per_frame = ", ".join(f"{k} {v / max(n, 1):.6g}" for k, v in system.counters.items())
        logging.getLogger("cart").info("processed %d frames on %s; per frame: %s", n,
                                       system.device, per_frame)
    finally:
        if viewer is not None:
            viewer.stop()
        for s in sinks:
            if hasattr(s, "close"):
                s.close()
        if timing is not None:
            timing.close()
        logging.getLogger().removeHandler(log_file)
        log_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
