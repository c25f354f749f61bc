from .depth import DepthModule  # noqa: F401
from .derivative import ImageDisparityDerivativeModule  # noqa: F401
from .disparity import ImageDisparityModule, ZEDImageDisparityModule  # noqa: F401
from .features import ImageFeatureDetectorModule  # noqa: F401
from .optflow import ImageOpticalFlowModule  # noqa: F401
from .planecluster import SuperPixelPlaneClusterModule  # noqa: F401
from .planefit import SuperPixelPlaneFitModule  # noqa: F401
from .planeseg import DisparityPlaneSegmentationModule  # noqa: F401
from .sp_planeseg import SuperPixelDisparityPlaneSegmentationModule  # noqa: F401
from .superpixels import SuperPixelModule  # noqa: F401
