"""The plain reference of a configured module chain over a stream of frames.

``Chain(modules, frames, device).replay(n, max_in_flight, snapshot_interval,
visit)`` works out, for frame ids 1..n of a stream that cycles through
`frames` (frame id t shows frames[(t - 1) % len(frames)]), what the
System should produce: each frame's planes and derivative histogram (handed
to ``visit``), the state it leaves after frame n, and the host step's final
plane parameters.  It follows the System's drain order: frame t's host
update (the running histogram and the provider) runs once frame
t + max_in_flight - 1 has been dispatched, or earlier at a state snapshot
(every `snapshot_interval` frames the System drains everything), so frame
t sees the ranges of the frames drained before it was dispatched.

The work is shared where the inputs repeat, which changes no value:
disparity, derivative and histogram depend on the frame alone, the flow on
the pair of frames, and the superpixel labels on the frames since the last
grid reset; each is computed once per distinct input.  The temporal vote,
the pixel classes and the host step run for every frame.

Supported: the module types and options of the benchmark's configurations
(superpixels in 'frame' statistics mode with one phase and no progressive
compactness; optflow; disparity; disparity_derivative; depth, which feeds
nothing that is compared; superpixel_disparity_planeseg with the
histogram-peak provider and the carried temporal vote with the 'gather'
warp).  Anything else raises, so a configuration the reference cannot
follow fails loudly.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from . import ops
from .graphs import RepeatInPlace, Replay
from .provider import HostStep


def _settings(modules: list[dict]) -> dict:
    """The chain's settings with the program's per-type defaults."""
    types = [m["type"] for m in modules]
    need = {"superpixels", "optflow", "disparity", "disparity_derivative",
            "superpixel_disparity_planeseg"}
    unknown = set(types) - need - {"depth"}
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


class Chain:
    """The module chain over `frames`, a list of host (left, right) BGR
    uint8 pairs; float work in `fdt` (float32: the reference)."""

    def __init__(self, modules: list[dict], frames: list, device, fdt=torch.float32):
        self.s = _settings(modules)
        self.frames = frames
        self.device = torch.device(device)
        self.fdt = fdt
        self.h, self.w = frames[0][0].shape[:2]
        self.grid, blocks = ops.block_grid(self.h, self.w, self.s["block_size"], self.device)
        self.num_labels = blocks + 1
        self._products: dict[int, dict] = {}
        self._flows: dict[tuple[int, int], torch.Tensor] = {}
        self._labels: dict[tuple, torch.Tensor] = {}
        self._frame_products = Replay(self._products_body)
        self._sweeps = RepeatInPlace(self._sweep)
        self._feature_list = None
        # Seconds spent on each kind of work, and on the whole replay.
        self.seconds = {"disparity": 0.0, "flow": 0.0, "relax": 0.0, "replay": 0.0}

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
        return gray, ops.bgr_to_ycrcb(left, self.fdt), deriv, hist

    def products(self, i: int) -> dict:
        """Frame i's gray, YCrCb, derivatives and histogram."""
        if i not in self._products:
            t0 = time.perf_counter()
            left, right = (torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                           for x in self.frames[i])
            gray, ycrcb, deriv, hist = (x.clone() for x in self._frame_products(left, right))
            self._products[i] = {"gray": gray, "ycrcb": ycrcb, "deriv": deriv, "hist": hist,
                                 "hist_np": hist.cpu().numpy()}
            self.seconds["disparity"] += time.perf_counter() - t0
        return self._products[i]

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

    def _features(self, i: int):
        """(data [C, H, W], features (kind, offset, channels, weight)) of
        frame i: derivative, YCrCb, then the pixel coordinates."""
        s, p = self.s, self.products(i)
        parts, features, offset = [], [], 0

        def add(kind, data, weight):
            nonlocal offset
            parts.append(data.to(self.fdt))
            features.append((kind, offset, data.shape[0], weight))
            offset += data.shape[0]

        if s["disparity_weight"] > 0:
            add("gaussian", p["deriv"].to(torch.float32).permute(2, 0, 1), s["disparity_weight"])
        add("gaussian", p["ycrcb"].to(torch.float32).permute(2, 0, 1), s["image_weight"])
        ys = torch.arange(self.h, dtype=torch.float32, device=self.device)
        xs = torch.arange(self.w, dtype=torch.float32, device=self.device)[None, :]
        coords = torch.stack([xs.expand(self.h, self.w), ys[:, None].expand(self.h, self.w)])
        add("compactness", coords, s["compactness_weight"])
        return torch.cat(parts).contiguous(), features

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
            data, self._feature_list = self._features(segment[-1])
            stat_img, pixel_rows = ops.relax_start(start, data, self.num_labels)
            labels, _ = self._sweeps(iterations, (start, stat_img), (pixel_rows,))
            self._labels[segment] = labels
            self._sync()
            self.seconds["relax"] += time.perf_counter() - t0
        return self._labels[segment]

    # ------------------------------------------------------------ replay

    def replay(self, n: int, max_in_flight: int, snapshot_interval: int,
               visit: Callable[[int, torch.Tensor, torch.Tensor], None]) -> dict:
        """Frames 1..n; visit(t, planes uint8 [H, W], histogram int32
        [256, 2]) for each.  Returns {"state": {path: tensor}, "params":
        Params}: the state after frame n, keyed as the System's state tree
        ("modules/<module>/<key>", "history/<key>"), and the provider's
        parameters once every frame has been drained."""
        s = self.s
        host = HostStep(s["update_interval"], s["reset_interval"])
        ranges_np = host.params.ranges()
        ranges = torch.from_numpy(ranges_np).to(self.device)
        drained = 0
        cycle = len(self.frames)
        warp = torch.full((s["distance"], self.h, self.w), ops.WARP_INVALID, dtype=torch.uint8,
                          device=self.device)
        pixel_prev = None
        labels = self.grid
        segment: tuple = ()
        t_start = time.perf_counter()

        def drain_to(limit: int):
            nonlocal drained, ranges_np
            while drained < limit:
                drained += 1
                got = host.update(drained, self.products((drained - 1) % cycle)["hist_np"])
                if got is not None:
                    ranges_np = got

        for t in range(1, n + 1):
            last_snapshot = (t - 1) // snapshot_interval * snapshot_interval if \
                snapshot_interval else 0
            before = ranges_np
            drain_to(max(t - max_in_flight, last_snapshot))
            if ranges_np is not before:
                ranges = torch.from_numpy(ranges_np).to(self.device)
            i = (t - 1) % cycle
            p = self.products(i)
            reset = t == 1 or t % s["reset_iterations"] == 0
            segment = (i,) if reset else segment + (i,)
            labels = self.labels(segment, self.grid if reset else labels,
                                 s["initial_iterations"] if reset else s["iterations"])
            pixel = ops.classify(p["deriv"][..., 0], ranges)
            flow = (torch.zeros((self.h, self.w, 2), dtype=torch.int16, device=self.device)
                    if t == 1 else self.flow((t - 2) % cycle, i))
            prev = torch.full_like(pixel, ops.WARP_INVALID) if pixel_prev is None else pixel_prev
            voted, warp = ops.temporal_vote_warped(pixel, prev, warp, flow, 2, True)
            planes = ops.superpixel_vote(voted, labels, self.num_labels)
            visit(t, planes, p["hist"])
            pixel_prev = pixel
        drain_to(n)
        self._sync()
        self.seconds["replay"] += time.perf_counter() - t_start
        i = (n - 1) % cycle
        state = {"modules/SuperPixelDetect/labels": labels,
                 "modules/ImageOpticalFlow/prev_gray": self.products(i)["gray"],
                 "modules/SPPlaneSegmentation/warp_votes": warp,
                 "history/planes_unsmoothed": pixel_prev[None]}
        return {"state": state, "params": host.params}

