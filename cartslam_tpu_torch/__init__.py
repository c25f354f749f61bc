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

# The package constants of the JAX package, with the same values as the ops
# that use them (ops/disparity.py, ops/derivative.py, ops/planeseg.py).
DISPARITY_INVALID = -32768
DERIVATIVE_INVALID = -32768

# Plane classes.
PLANE_HORIZONTAL = 0
PLANE_VERTICAL = 1
PLANE_UNKNOWN = 2
