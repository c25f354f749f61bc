"""Host-side data sources: jax-free copies of ``cartslam_tpu.sources``.

Frames are dicts of host numpy arrays (BGR uint8 ``left``/``right``); the
run loop moves them to the pipeline's device.
"""

from .base import CameraIntrinsics, DataSource, to_grayscale  # noqa: F401
from .kitti import KITTIDataSource  # noqa: F401
from .preloaded import PreloadedSource  # noqa: F401
from .synthetic import SyntheticDataSource  # noqa: F401
from .zed import ZEDDataSource  # noqa: F401
