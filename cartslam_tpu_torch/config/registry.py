"""JSON config reader (counterpart of cartslam_tpu/config/registry.py).

Same schema ({"data_source": {...}, "modules": [...]}, or a source file and
a modules file), the same module and source types and the same per-type
defaults.  The host module types (visualizations, ``planefit``,
``planecluster``) run only under a System.  ``build_system`` /
``read_system_config`` return the System (runtime/system.py), as the JAX
functions do; ``build_pipeline`` / ``read_config`` return the pipeline and
its source alone.  A ``parallel`` block with ``"mode": "spatial"`` builds
the height-sharded SpatialPipeline over the same modules, whose step a
System on the card captures as a CUDA graph per variant, as the flagship's.
The
multi-sequence modes run only under a System: ``"mode": "multiseq"`` builds
a MultiSeqSystem over ``batch`` sources (default: the visible cards summed
over the processes, as JAX's ``len(jax.devices())``), and ``"mode":
"spatial"`` with ``"sequences"`` > 1 a SpatialMultiSeqSystem.  A
``"multihost"`` block joins the multiseq mode's processes
(parallel/distributed.py) and builds this process's share of the batch; the
spatial mode ignores it with a warning, as the JAX registry does.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from .. import models
from ..runtime.module import HostModule, Module, PipelineContext, checked_device
from ..parallel.distributed import global_data_layout, global_device_count, initialize_multihost
from ..parallel.spatial_flagship import SpatialPipeline
from ..parallel.system import MultiSeqSystem, SpatialMultiSeqSystem
from ..runtime.pipeline import Pipeline
from ..runtime.system import System
from ..sources import DataSource, KITTIDataSource, SyntheticDataSource, ZEDDataSource
from ..utils.plane_params import (
    HistogramPeakPlaneParameterProvider,
    StaticPlaneParameterProvider,
)


def _read_parameter_provider(cfg: dict):
    ptype = cfg["type"]
    if ptype == "static":
        h = (cfg["horizontal_range_min"], cfg["horizontal_range_max"])
        v = (cfg["vertical_range_min"], cfg["vertical_range_max"])
        return StaticPlaneParameterProvider(h, v)
    if ptype == "histogram_peak":
        return HistogramPeakPlaneParameterProvider()
    raise ValueError(f"unknown parameter provider type '{ptype}'")


def create_data_source(cfg) -> DataSource:
    """A source from its config dict, or a pre-constructed DataSource
    (e.g. a PreloadedSource) as it is."""
    if isinstance(cfg, DataSource):
        return cfg
    stype = cfg["type"]
    if stype == "kitti":
        return KITTIDataSource(
            cfg["path"], cfg.get("sequence", 0),
            decode_workers=cfg.get("decode_workers", 6),
        )
    if stype == "zed":
        return ZEDDataSource(
            cfg["path"],
            cfg.get("include_disparity", False),
            real_time_mode=cfg.get("svo_real_time_mode", False),
            fps=cfg.get("fps", 15.0),
            decode_workers=cfg.get("decode_workers", 6),
        )
    if stype == "synthetic":
        return SyntheticDataSource(
            image_size=tuple(cfg.get("image_size", (96, 192))),
            num_frames=cfg.get("num_frames", 20),
            seed=cfg.get("seed", 0),
        )
    raise ValueError(f"unknown data source type '{stype}'")


class ConfigState:
    """Carries cross-module wiring facts during config interpretation."""

    def __init__(self, image_size: tuple[int, int]):
        self.image_size = image_size
        self.superpixel_module: models.SuperPixelModule | None = None

    def num_superpixel_labels(self) -> int:
        if self.superpixel_module is None:
            raise ValueError("this module requires a 'superpixels' module")
        return self.superpixel_module.num_labels


def build_module(cfg: dict, st: ConfigState) -> Module | HostModule:
    mtype = cfg["type"]
    g = cfg.get
    if mtype == "disparity":
        return models.ImageDisparityModule(
            st.image_size,
            min_disparity=g("min_disparity", 4),
            num_disparities=g("num_disparities", 256),
            block_size=g("block_size", 3),
            smoothing_radius=g("smoothing_radius", -1),
            smoothing_iterations=g("smoothing_iterations", 5),
        )
    if mtype == "zed_disparity":
        return models.ZEDImageDisparityModule(
            smoothing_radius=g("smoothing_radius", -1),
            smoothing_iterations=g("smoothing_iterations", 5),
        )
    if mtype == "disparity_derivative":
        return models.ImageDisparityDerivativeModule()
    if mtype == "depth":
        return models.DepthModule()
    if mtype == "optflow":
        return models.ImageOpticalFlowModule(
            st.image_size,
            levels=g("levels", 4),
            search=g("search", 4),
            refine=g("refine", 2),
            base_level=g("base_level", 1),
            med_passes=g("med_passes", 2),
        )
    if mtype == "superpixels":
        direct = g("direct_clique_cost", 0.5)
        m = models.SuperPixelModule(
            st.image_size,
            initial_iterations=g("initial_iterations", 18),
            iterations=g("iterations", 6),
            block_size=g("block_size", 12),
            reset_iterations=g("reset_iterations", 64),
            direct_clique_cost=direct,
            diagonal_clique_cost=g("diagonal_clique_cost", direct / np.sqrt(2)),
            compactness_weight=g("compactness_weight", 0.1),
            progressive_compactness_cost=g("progressive_compactness_cost", 0.0),
            image_weight=g("image_weight", 1.5),
            disparity_weight=g("disparity_weight", 1.0),
            relax_phases=g("relax_phases", 1),
            stats_refresh=g("stats_refresh", "frame"),
        )
        st.superpixel_module = m
        return m
    if mtype == "disparity_planeseg":
        return models.DisparityPlaneSegmentationModule(
            _read_parameter_provider(cfg["parameter_provider"]),
            update_interval=g("update_interval", 30),
            reset_interval=g("reset_interval", 10),
            use_temporal_smoothing=g("use_temporal_smoothing", False),
            temporal_smoothing_distance=g("temporal_smoothing_distance", 3),
            temporal_mode=g("temporal_mode", "carried"),
            warp_mode=g("warp_mode", "auto"),
            max_warp_y=g("max_warp_y", 32),
            max_warp_x=g("max_warp_x", 64),
        )
    if mtype == "superpixel_disparity_planeseg":
        return models.SuperPixelDisparityPlaneSegmentationModule(
            _read_parameter_provider(cfg["parameter_provider"]),
            num_labels=st.num_superpixel_labels(),
            update_interval=g("update_interval", 30),
            reset_interval=g("reset_interval", 10),
            use_temporal_smoothing=g("use_temporal_smoothing", False),
            temporal_smoothing_distance=g("temporal_smoothing_distance", 3),
            temporal_mode=g("temporal_mode", "carried"),
            warp_mode=g("warp_mode", "auto"),
            max_warp_y=g("max_warp_y", 32),
            max_warp_x=g("max_warp_x", 64),
        )
    if mtype == "features":
        ftype = g("feature_type", "orb")
        if ftype != "orb":
            raise ValueError(f"unknown feature type '{ftype}'")
        return models.ImageFeatureDetectorModule(max_keypoints=g("keypoints", 5000))
    if mtype == "planefit":
        return models.SuperPixelPlaneFitModule(num_labels=st.num_superpixel_labels(),
                                               fit_method=g("fit_method", "ransac"))
    if mtype == "planecluster":
        return models.SuperPixelPlaneClusterModule(num_labels=st.num_superpixel_labels(),
                                                   fit_method=g("fit_method", "ransac"))

    # Visualization modules are host-side.
    from ..viz import host_modules as vm

    if mtype == "disparity_visualization":
        return vm.DisparityVisualization()
    if mtype == "disparity_derivative_visualization":
        return vm.DerivativeVisualization()
    if mtype == "depth_visualization":
        return vm.DepthVisualization()
    if mtype == "optflow_visualization":
        return vm.OpticalFlowVisualization(points=g("points", 10))
    if mtype == "superpixels_visualization":
        return vm.SuperPixelVisualization()
    if mtype == "disparity_planeseg_visualization":
        return vm.PlaneSegmentationVisualization(
            show_histogram=g("show_histogram", True),
            show_unsmoothed=g("show_unsmoothed", True),
        )
    if mtype == "bev_planeseg_visualization":
        return vm.BEVVisualization()
    if mtype == "features_visualization":
        return vm.FeatureVisualization()
    if mtype == "planefit_visualization":
        return vm.PlaneFitVisualization()
    raise ValueError(f"unknown module type '{mtype}'")


def _warn_warp_bound(modules: list[Module], spatial: bool) -> None:
    """Warn when 'select' warp mode can drop temporal votes: it drops votes
    whose vertical flow exceeds max_warp_y, and the flow module's static
    bound says whether that can happen.  ('auto' is 'gather' in the port,
    which keeps them; the spatial mode always takes 'select'.)"""
    flows = [m for m in modules if isinstance(m, models.ImageOpticalFlowModule)]
    if not flows:
        return
    bound = flows[0].flow_bound()
    for m in modules:
        if (getattr(m, "temporal", False) and (spatial or m.warp_mode == "select")
                and m.max_warp_y < bound):
            logging.getLogger("cart.config").warning(
                "dense_flow's static vertical bound is %d px but max_warp_y=%d: "
                "temporal votes with larger vertical flow are dropped in 'select' "
                "warp mode (raise max_warp_y or set warp_mode='gather' to keep them)",
                bound, m.max_warp_y,
            )


def _replicate_sources(parallel: dict, source_cfg, source, batch: int,
                       image_size: tuple[int, int], share: range | None = None) -> list[DataSource]:
    """The sources of the global sequences `share` (default all B) of a
    lock-step parallel run: `parallel.sources` configs (or DataSources), or
    the primary config replicated (a synthetic source's seed + j for global
    sequence j, in every layout); the primary source is sequence 0's."""
    src_cfgs = parallel.get("sources")
    if src_cfgs is None:
        src_cfgs = []
        for i in range(batch):
            c = dict(source_cfg)
            if c.get("type") == "synthetic":
                c["seed"] = int(c.get("seed", 0)) + i
            src_cfgs.append(c)
    if len(src_cfgs) != batch:
        raise ValueError("parallel.sources length must equal the sequence count")
    sources = [source if j == 0 else create_data_source(src_cfgs[j])
               for j in (range(batch) if share is None else share)]
    for s in sources:
        if s.get_image_size() != image_size:
            raise ValueError("all parallel sources must share image size")
    return sources


_MULTISEQ_KEYS = {"checkpoint_path", "checkpoint_interval", "resume_from", "data_timeout",
                  "snapshot_interval"}


def _split_multiseq_kwargs(system_kwargs: dict) -> dict:
    """The System options MultiSeqSystem takes; a dropped option that is set
    is named in a warning."""
    dropped = sorted(k for k, v in system_kwargs.items() if v and k not in _MULTISEQ_KEYS)
    if dropped:
        logging.getLogger("cart.config").warning(
            "multi-sequence mode ignores system options: %s", dropped)
    return {k: v for k, v in system_kwargs.items() if k in _MULTISEQ_KEYS}


def _multi_sequence(parallel: dict | None) -> bool:
    """Whether a parallel block runs several sequences (multiseq, or the
    spatial mode's `sequences` > 1)."""
    if parallel is None:
        return False
    return (parallel.get("mode", "multiseq") == "multiseq"
            or int(parallel.get("sequences", 1)) > 1)


def _multiseq_share(parallel: dict, device) -> tuple[int, range]:
    """(global batch, this process's global sequences) of the multiseq
    mode: a "multihost" block joins the processes first; `batch` defaults
    to the visible cards summed over the processes."""
    if "multihost" in parallel:
        initialize_multihost(parallel["multihost"])
    batch = (int(parallel["batch"]) if "batch" in parallel
             else global_device_count(device.type))
    return batch, global_data_layout(device.type).share(batch)


def _build_spatial_pipeline(parallel: dict, ctx: PipelineContext, modules) -> SpatialPipeline:
    """Height-shard the configured module list: `parallel.devices` is the
    shard count (default 1), divided by `sequences` in the composed mode,
    all shards on ctx.device in this version.  The flow's seam knobs live
    under `parallel` (they describe the sharding, not the flow math)."""
    n = int(parallel.get("devices", 1))
    seqs = int(parallel.get("sequences", 1))
    if seqs > 1:
        if n % seqs:
            raise ValueError(f"parallel.devices={n} must divide by sequences={seqs}")
        n //= seqs
    h_local = ctx.height // n if n > 0 and ctx.height % n == 0 else 0
    for m in modules:
        if isinstance(m, models.ImageOpticalFlowModule):
            if "flow_mode" in parallel:
                m.spatial_mode = str(parallel["flow_mode"])
            if "flow_halo" in parallel:
                m.spatial_halo = int(parallel["flow_halo"])
            elif h_local and m.spatial_mode == "sharded":
                # The apron cannot exceed one shard's rows.
                m.spatial_halo = min(m.spatial_halo, h_local)
    return SpatialPipeline(ctx, modules, n)


def _build(source_cfg, modules_cfg: list[dict], device, grayscale: bool,
           parallel: dict | None):
    """(pipeline, source, host modules) from config dicts."""
    device = checked_device(device)
    if parallel is not None:
        mode = parallel.get("mode", "multiseq")
        if mode not in ("multiseq", "spatial"):
            raise ValueError(f"unknown parallel mode '{mode}'")
        if mode == "spatial" and "multihost" in parallel:
            logging.getLogger("cart.config").warning(
                "the spatial mode ignores parallel.multihost (one process holds the grid)")
    source = create_data_source(source_cfg)
    h, w = source.get_image_size()
    st = ConfigState((h, w))
    modules: list[Module] = []
    host_modules: list[HostModule] = []
    for cfg in modules_cfg:
        m = build_module(cfg, st)
        (host_modules if isinstance(m, HostModule) else modules).append(m)
    spatial = parallel is not None and parallel.get("mode", "multiseq") == "spatial"
    _warn_warp_bound(modules, spatial=spatial)
    ctx = PipelineContext(
        height=h,
        width=w,
        q=np.asarray(source.get_camera_intrinsics().q, np.float32),
        device=device,
        grayscale=grayscale,
    )
    if spatial:
        return _build_spatial_pipeline(parallel, ctx, modules), source, host_modules
    return Pipeline(ctx, modules), source, host_modules


def build_pipeline(source_cfg, modules_cfg: list[dict], *, device="cuda",
                   grayscale: bool = False,
                   parallel: dict | None = None) -> tuple[Pipeline | SpatialPipeline, DataSource]:
    """(Pipeline on `device`, its data source) from config dicts.  The
    device defaults to the card; without a GPU that raises.  `parallel`:
    a config's parallel block (``"mode": "spatial"``).  Visualization types
    are host modules and the multi-sequence modes drive several sources,
    which only a System does: here they are refused."""
    if _multi_sequence(parallel):
        raise ValueError("the multi-sequence modes run B sources through a System: "
                         "use build_system")
    pipeline, source, host_modules = _build(source_cfg, modules_cfg, device, grayscale,
                                            parallel)
    if host_modules:
        raise ValueError(f"host modules {[m.name for m in host_modules]} need a System: "
                         "use build_system")
    return pipeline, source


def build_system(source_cfg, modules_cfg: list[dict], *, grayscale: bool = False,
                 timing=None, image_sink=None, max_frames: int | None = None,
                 max_in_flight: int = 4, extra_fetch_keys=(), parallel: dict | None = None,
                 device="cuda", **system_kwargs) -> System:
    """The System (runtime/system.py) over the configured modules, with the
    JAX build_system's arguments plus `device` (default the card).  The
    spatial mode goes through the System too, its step captured on the card
    as the flagship's.  The
    multi-sequence modes return a MultiSeqSystem (``"mode": "multiseq"``)
    or a SpatialMultiSeqSystem (``"sequences"`` > 1) over B sources
    (_replicate_sources), with the System options they take."""
    pipeline, source, host_modules = _build(source_cfg, modules_cfg, device, grayscale,
                                            parallel)
    kw = dict(timing=timing, image_sink=image_sink, max_frames=max_frames,
              max_in_flight=max_in_flight, extra_fetch_keys=extra_fetch_keys)
    if _multi_sequence(parallel):
        if isinstance(pipeline, SpatialPipeline):
            cls, batch = SpatialMultiSeqSystem, int(parallel["sequences"])
            share = range(batch)
        else:
            cls = MultiSeqSystem
            batch, share = _multiseq_share(parallel, pipeline.ctx.device)
        sources = _replicate_sources(parallel, source_cfg, source, batch,
                                     (pipeline.ctx.height, pipeline.ctx.width), share)
        ms_kwargs = _split_multiseq_kwargs(system_kwargs)
        return cls(sources, pipeline, host_modules, **kw, **ms_kwargs)
    return System(source, pipeline, host_modules, **kw, **system_kwargs)


def _read(paths) -> tuple[dict, list[dict], dict]:
    """(source config, module configs, the combined config's "grayscale"
    and "parallel" as keywords) of one combined config or a (source
    config, modules config) pair."""

    def load(p):
        with open(os.path.expanduser(p)) as f:
            return json.load(f)

    if len(paths) == 1:
        data = load(paths[0])
        if "data_source" not in data or "modules" not in data:
            raise ValueError("config must contain data_source and modules")
        kw = {"grayscale": True} if data.get("grayscale") else {}
        if "parallel" in data:
            kw["parallel"] = data["parallel"]
        return data["data_source"], data["modules"], kw
    if len(paths) == 2:
        return load(paths[0]), load(paths[1]), {}
    raise ValueError("expected 1 or 2 config paths")


def read_config(*paths: str, device="cuda",
                source: DataSource | None = None) -> tuple[Pipeline | SpatialPipeline, DataSource]:
    """One combined config, or a (source config, modules config) pair.
    source: a DataSource that replaces the config's data_source (e.g.
    preloaded frames standing in for a dataset that is not on disk)."""
    src, mods, kw = _read(paths)
    return build_pipeline(src if source is None else source, mods, device=device, **kw)


def read_system_config(*paths: str, source: DataSource | None = None, **kwargs) -> System:
    """One combined config, or a (source config, modules config) pair, as
    a System; keyword arguments as build_system's (a config's own
    "grayscale": true wins, its "parallel" block is the default).  source:
    a DataSource that replaces the config's data_source, as read_config's."""
    src, mods, kw = _read(paths)
    if kw.get("grayscale"):
        kwargs["grayscale"] = True
    if "parallel" in kw:
        kwargs.setdefault("parallel", kw["parallel"])
    return build_system(src if source is None else source, mods, **kwargs)
