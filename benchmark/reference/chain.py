"""The plain reference of a configured module chain over B streams of frames
in lock-step: the reference module of the superpixel plane segmentation
(a configuration names it in its ``reference`` key; benchmark/compare.py
says what a reference module gives).

``replay(chains, n, max_in_flight, snapshot_interval, visit, keys)`` works
out, for rounds 1..n of B streams (one ``Chain`` each) that advance
together, what the System should produce: each round's outputs of `keys`
(planes, derivative histograms, depth) of every stream (handed to
``visit`` as a dict, each stacked [B, ...]), the state the streams leave
after round n (batch-leading), and the host step's final plane parameters
(the global ``plane_parameters``).  Stream b's round t shows its
frames[(t - 1) % len(frames)].  One host step serves the batch, as the
program's multi-sequence mode runs one provider: each drained round feeds
it the int64 sum of the B streams' histograms.  It follows the System's
drain order: round t's host update (the running histogram and the
provider) runs once round t + max_in_flight - 1 has been dispatched, or
earlier at a state snapshot (every `snapshot_interval` rounds the System
drains everything), so round t sees the ranges of the rounds drained
before it was dispatched.  Each stream keeps its own labels, flow input,
temporal vote and warp state.  A single stream is a batch of one: the same
computation, with a histogram sum of one term.

The work is shared where the inputs repeat, which changes no value:
disparity, derivative, histogram and depth depend on the frame alone, the
flow on the pair of frames, and the superpixel labels on the frames since
the last grid reset; each is computed once per distinct input of a stream.  The
temporal vote, the pixel classes and the host step run for every frame.
The streams' chains replay the same CUDA graphs (graphs.py): their shapes
and settings are the same.

Supported: the module types and options of the benchmark's configurations
(superpixels in 'frame' statistics mode with one phase and no progressive
compactness; optflow; disparity; disparity_derivative; depth, whose output
is compared where the traffic fetches it; superpixel_disparity_planeseg
with the histogram-peak provider and the carried temporal vote with the
'gather' warp).  Anything else raises, so a configuration the reference cannot
follow fails loudly.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from . import ops
from .checks import Check
from .graphs import RepeatInPlace, Replay
from .provider import HostStep

PLANES, HIST, DEPTH = "planes", "disparity_derivative_histogram", "depth"
CHECKS = (
    Check(PLANES, "planes_px_diff", "pixels of the delivered frames' planes that differ, over "
          "every stream of every delivered round"),
    Check(HIST, "hist_bins_diff", "derivative-histogram bins of the delivered frames that "
          "differ, over every stream of every delivered round", always=True),
    Check(DEPTH, "depth_diff", "elements (X, Y, Z) of the delivered frames' depth whose "
          "float32 bit patterns differ, over every stream of every delivered round",
          kept="first"),
)
# The host global compared (params_diff), and its fields.
GLOBAL = "plane_parameters"
PARAM_FIELDS = ("horizontal_range", "vertical_range", "horizontal_center", "vertical_center")


def _settings(modules: list[dict]) -> dict:
    """The chain's settings with the program's per-type defaults."""
    types = [m["type"] for m in modules]
    need = {"superpixels", "optflow", "disparity", "disparity_derivative",
            "superpixel_disparity_planeseg"}
    unknown = set(types) - need - {DEPTH}
    if unknown or not need <= set(types):
        raise NotImplementedError(f"the reference follows {sorted(need)} (+ depth), not {types}")
    cfg = {m["type"]: m for m in modules}
    sp, fl, dp, ps = (cfg["superpixels"], cfg["optflow"], cfg["disparity"],
                      cfg["superpixel_disparity_planeseg"])
    direct = sp.get("direct_clique_cost", 0.5)
    s = {
        "initial_iterations": sp.get("initial_iterations", 18),
        "iterations": sp.get("iterations", 6),
        "block_size": sp.get("block_size", 12),
        "reset_iterations": sp.get("reset_iterations", 64),
        "direct_cost": float(direct),
        "diagonal_cost": float(sp.get("diagonal_clique_cost", direct / np.sqrt(2))),
        "compactness_weight": float(sp.get("compactness_weight", 0.1)),
        "image_weight": float(sp.get("image_weight", 1.5)),
        "disparity_weight": float(sp.get("disparity_weight", 1.0)),
        "flow": {"levels": fl.get("levels", 4), "search": fl.get("search", 4),
                 "refine": fl.get("refine", 2), "base_level": fl.get("base_level", 1),
                 "fine_refine": 1, "med_passes": fl.get("med_passes", 2)},
        "min_disparity": dp.get("min_disparity", 4),
        "num_disparities": dp.get("num_disparities", 256),
        "smoothing_radius": dp.get("smoothing_radius", -1),
        "smoothing_iterations": dp.get("smoothing_iterations", 5),
        "update_interval": ps.get("update_interval", 30),
        "reset_interval": ps.get("reset_interval", 10),
        "distance": ps.get("temporal_smoothing_distance", 3),
        "depth": DEPTH in types,
    }
    if (sp.get("relax_phases", 1) != 1 or sp.get("stats_refresh", "frame") != "frame"
            or sp.get("progressive_compactness_cost", 0.0) > 0):
        raise NotImplementedError("the reference relaxes in 'frame' statistics mode, one "
                                  "phase, no progressive compactness")
    if (not ps.get("use_temporal_smoothing", False)
            or ps.get("temporal_mode", "carried") != "carried"
            or ps.get("warp_mode", "auto") not in ("auto", "gather")):
        raise NotImplementedError("the reference votes with the carried 'gather' warp")
    if ps["parameter_provider"]["type"] != "histogram_peak":
        raise NotImplementedError("the reference's provider is the histogram-peak one")
    return s


def outputs(modules: list[dict]) -> set[str]:
    """The keys the chain of `modules` produces for the comparison."""
    return {PLANES, HIST} | ({DEPTH} if _settings(modules)["depth"] else set())


def _field(params, name: str) -> list | None:
    """A plane-parameter field as a list of ints (None where absent)."""
    value = getattr(params, name, None)
    return None if value is None else [int(x) for x in np.ravel(np.asarray(value))]


def global_diff(got, want) -> int:
    """Fields of the plane parameters that differ."""
    return sum(_field(got, f) != _field(want, f) for f in PARAM_FIELDS)


class Chain:
    """One stream's module chain over `frames`, a list of host (left, right)
    BGR uint8 pairs, seen by cameras of reprojection matrix `q` (float32 [4,
    4]); float work in `fdt` (float32: the reference).  `like`: a chain of
    the same settings and geometry whose CUDA graphs this one replays."""

    def __init__(self, modules: list[dict], frames: list, q, device, fdt=torch.float32,
                 like: "Chain | None" = None):
        self.s = _settings(modules)
        self.frames = frames
        self.q = torch.as_tensor(np.asarray(q, dtype=np.float32))
        self.device = torch.device(device)
        self.fdt = fdt
        self.h, self.w = frames[0][0].shape[:2]
        self.grid, blocks = ops.block_grid(self.h, self.w, self.s["block_size"], self.device)
        self.num_labels = blocks + 1
        self._products: dict[int, dict] = {}
        self._flows: dict[tuple[int, int], torch.Tensor] = {}
        self._labels: dict[tuple, torch.Tensor] = {}
        self._feature_list = self._feature_layout()
        if like is None:
            self._frame_products = Replay(self._products_body)
            self._sweeps = RepeatInPlace(self._sweep)
        else:
            self._frame_products, self._sweeps = like._frame_products, like._sweeps
        # Seconds spent on each kind of work.
        self.seconds = {"disparity": 0.0, "flow": 0.0, "relax": 0.0, "depth": 0.0}

    # ------------------------------------------------ per distinct input

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _products_body(self, left, right):
        s = self.s
        gray = ops.bgr_to_gray(left, self.fdt)
        disp = ops.sgm_disparity(gray, ops.bgr_to_gray(right, self.fdt),
                                 min_disparity=s["min_disparity"],
                                 num_disparities=s["num_disparities"], p1=10, p2=120,
                                 uniqueness=12)
        if s["smoothing_radius"] > 0:
            # The upper validity bound is the image width: the reference's
            # ImageDisparityModule constructor.
            disp = ops.interpolate(disp, radius=s["smoothing_radius"],
                                   iterations=s["smoothing_iterations"],
                                   min_disparity=s["min_disparity"] * 16, max_disparity=self.w)
        deriv, hist = ops.directional_derivatives(disp)
        return gray, ops.bgr_to_ycrcb(left, self.fdt), disp, deriv, hist

    def products(self, i: int) -> dict:
        """Frame i's gray, YCrCb, disparity, derivatives and histogram."""
        if i not in self._products:
            t0 = time.perf_counter()
            left, right = (torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                           for x in self.frames[i])
            gray, ycrcb, disp, deriv, hist = (x.clone()
                                              for x in self._frame_products(left, right))
            self._products[i] = {"gray": gray, "ycrcb": ycrcb, "disparity": disp,
                                 "deriv": deriv, "hist": hist, "hist_np": hist.cpu().numpy()}
            self.seconds["disparity"] += time.perf_counter() - t0
        return self._products[i]

    def depth(self, t: int) -> torch.Tensor:
        """Frame t's depth float32 [H, W, 3] from its disparity."""
        p = self.products((t - 1) % len(self.frames))
        if "depth" not in p:
            t0 = time.perf_counter()
            p["depth"] = ops.reproject_to_3d(p["disparity"], self.q, self.fdt)
            self._sync()
            self.seconds["depth"] += time.perf_counter() - t0
        return p["depth"]

    def flow(self, i_prev: int, i: int) -> torch.Tensor:
        """int16 S10.5 flow [H, W, 2] from frame i back to frame i_prev."""
        key = (i_prev, i)
        if key not in self._flows:
            t0 = time.perf_counter()
            f = ops.dense_flow(self.products(i)["gray"], self.products(i_prev)["gray"],
                               fdt=self.fdt, **self.s["flow"])
            self._flows[key] = ops.to_s10_5(f)
            self._sync()
            self.seconds["flow"] += time.perf_counter() - t0
        return self._flows[key]

    def _feature_layout(self) -> list:
        """(kind, offset, channels, weight) of the relaxation's data
        channels, in the order ``_features`` stacks them: the derivative's
        2 (where weighted), YCrCb's 3, then the 2 pixel coordinates."""
        s = self.s
        kinds = ([("gaussian", 2, s["disparity_weight"])] if s["disparity_weight"] > 0 else [])
        kinds += [("gaussian", 3, s["image_weight"]), ("compactness", 2, s["compactness_weight"])]
        features, offset = [], 0
        for kind, channels, weight in kinds:
            features.append((kind, offset, channels, weight))
            offset += channels
        return features

    def _features(self, i: int) -> torch.Tensor:
        """data [C, H, W] of frame i in ``_feature_layout``'s order."""
        s, p = self.s, self.products(i)
        ys = torch.arange(self.h, dtype=torch.float32, device=self.device)
        xs = torch.arange(self.w, dtype=torch.float32, device=self.device)[None, :]
        coords = torch.stack([xs.expand(self.h, self.w), ys[:, None].expand(self.h, self.w)])
        parts = ([p["deriv"].to(torch.float32).permute(2, 0, 1)]
                 if s["disparity_weight"] > 0 else [])
        parts += [p["ycrcb"].to(torch.float32).permute(2, 0, 1), coords]
        return torch.cat([x.to(self.fdt) for x in parts]).contiguous()

    def _sweep(self, labels, stat_img, pixel_rows):
        return ops.relax_sweep(labels, stat_img, pixel_rows, self._feature_list,
                               pixel_rows.shape[0] // 2, self.s["direct_cost"],
                               self.s["diagonal_cost"])

    def labels(self, segment: tuple, start: torch.Tensor, iterations: int) -> torch.Tensor:
        """The labels after the frames `segment` (cycle indices since the
        last grid reset), the last of them relaxed from `start`: one
        statistics table of the incoming labels, then `iterations` sweeps."""
        if segment not in self._labels:
            t0 = time.perf_counter()
            stat_img, pixel_rows = ops.relax_start(start, self._features(segment[-1]),
                                                   self.num_labels)
            labels, _ = self._sweeps(iterations, (start, stat_img), (pixel_rows,))
            self._labels[segment] = labels
            self._sync()
            self.seconds["relax"] += time.perf_counter() - t0
        return self._labels[segment]

    # ------------------------------------------------ the stream's frames

    def begin(self) -> None:
        """The stream's state before frame 1."""
        self._warp = torch.full((self.s["distance"], self.h, self.w), ops.WARP_INVALID,
                                dtype=torch.uint8, device=self.device)
        self._pixel_prev = None
        self._now = self.grid
        self._segment: tuple = ()
        self._last = 0

    def histogram(self, t: int) -> np.ndarray:
        """Frame t's derivative histogram int32 [256, 2] on the host."""
        return self.products((t - 1) % len(self.frames))["hist_np"]

    def step(self, t: int, ranges: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Frame t (the one after the last) with the classification ranges
        int32 [2, 2]: (planes uint8 [H, W], histogram int32 [256, 2])."""
        s, cycle = self.s, len(self.frames)
        i = (t - 1) % cycle
        p = self.products(i)
        reset = t == 1 or t % s["reset_iterations"] == 0
        self._segment = (i,) if reset else self._segment + (i,)
        self._now = self.labels(self._segment, self.grid if reset else self._now,
                                s["initial_iterations"] if reset else s["iterations"])
        pixel = ops.classify(p["deriv"][..., 0], ranges)
        flow = (torch.zeros((self.h, self.w, 2), dtype=torch.int16, device=self.device)
                if t == 1 else self.flow((t - 2) % cycle, i))
        prev = (torch.full_like(pixel, ops.WARP_INVALID) if self._pixel_prev is None
                else self._pixel_prev)
        voted, self._warp = ops.temporal_vote_warped(pixel, prev, self._warp, flow, 2, True)
        self._pixel_prev = pixel
        self._last = t
        return ops.superpixel_vote(voted, self._now, self.num_labels), p["hist"]

    def state(self) -> dict:
        """The state after the last frame, keyed as the System's state tree
        ("modules/<module>/<key>", "history/<key>")."""
        return {"modules/SuperPixelDetect/labels": self._now,
                "modules/ImageOpticalFlow/prev_gray": self.products(
                    (self._last - 1) % len(self.frames))["gray"],
                "modules/SPPlaneSegmentation/warp_votes": self._warp,
                "history/planes_unsmoothed": self._pixel_prev[None]}


def chains(modules: list[dict], streams: list, q, device, fdt=torch.float32) -> list[Chain]:
    """One chain a stream (`streams`: each stream's frame cycle; `q`: the
    cameras' reprojection matrix), all replaying the first one's CUDA
    graphs."""
    first = Chain(modules, streams[0], q, device, fdt)
    return [first] + [Chain(modules, f, q, device, fdt, like=first) for f in streams[1:]]


def replay(chains: list[Chain], n: int, max_in_flight: int, snapshot_interval: int,
           visit: Callable[[int, dict], None], keys) -> dict:
    """Rounds 1..n of the streams in lock-step; visit(t, {key: [B, ...]})
    for each with the outputs of `keys`: planes uint8 [B, H, W], histograms
    int32 [B, 256, 2], depth float32 [B, H, W, 3].  Returns {"state": {path:
    tensor [B, ...]}, "global": Params}: the streams' state after round n,
    and the provider's parameters once every round has been drained."""
    s = chains[0].s
    device = chains[0].device
    host = HostStep(s["update_interval"], s["reset_interval"])
    ranges_np = host.params.ranges()
    ranges = torch.from_numpy(ranges_np).to(device)
    drained = 0
    for c in chains:
        c.begin()

    def drain_to(limit: int):
        nonlocal drained, ranges_np
        while drained < limit:
            drained += 1
            total = np.sum([c.histogram(drained) for c in chains], axis=0, dtype=np.int64)
            got = host.update(drained, total)
            if got is not None:
                ranges_np = got

    for t in range(1, n + 1):
        last_snapshot = (t - 1) // snapshot_interval * snapshot_interval if \
            snapshot_interval else 0
        before = ranges_np
        drain_to(max(t - max_in_flight, last_snapshot))
        if ranges_np is not before:
            ranges = torch.from_numpy(ranges_np).to(device)
        planes, hists = zip(*(c.step(t, ranges) for c in chains))
        out = {PLANES: planes, HIST: hists}
        if DEPTH in keys:
            out[DEPTH] = [c.depth(t) for c in chains]
        visit(t, {k: torch.stack(out[k]) for k in keys})
    drain_to(n)
    states = [c.state() for c in chains]
    return {"state": {path: torch.stack([st[path] for st in states]) for path in states[0]},
            "global": host.params}
