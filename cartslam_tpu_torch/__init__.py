"""cartslam_tpu_torch — the PyTorch + CUDA port of cartslam_tpu.

The JAX package (``cartslam_tpu``) stays the reference; this package runs the
same pipeline eagerly with PyTorch on an explicit device and hand-written
CUDA kernels (sm_90a) where the JAX package used Pallas kernels.  It imports
no JAX and nothing of the JAX package.

Layout (file names follow the JAX package, so counterparts are easy to find):
    runtime/   module contracts, pipeline composer, the System loop and its
               captured step (CUDA graphs), run loop, checkpoints, timing
               CSVs, state mapping
    ops/       plain tensor ops (color, stereo, disparity, derivative, depth,
               superpixels, planeseg)
    models/    pipeline modules with the reference's data contracts
    kernels/   the CUDA build (nvcc -> one shared library, loaded with ctypes)
               and the kernel wrappers with their plain PyTorch versions
    csrc/      the CUDA C++ sources
    sources/   host-side data sources (synthetic, KITTI, preloaded)
    utils/     host-side plane-parameter providers, peak finding, colors,
               image files, fetch watchdog
    config/    JSON config reader with the JAX package's schema and defaults
    viz/       host visualization modules and image sinks
"""
