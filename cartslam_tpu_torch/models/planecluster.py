"""SuperPixelPlaneClusterModule: per-superpixel planes + region growing
(counterpart of cartslam_tpu/models/planecluster.py).

Reference: src/modules/planecluster.cpp.  The per-label plane fits (an
OpenMP RANSAC per superpixel there) are one vectorized device call on
``ctx.device``, on the module's own stream; the region-growing merge over
the label adjacency graph stays on the host, with the reference's merge
rule: neighbors join a cluster when |d sin yaw| + |d cos yaw| < 0.2, same
for pitch, and |d offset| < 3; clusters below 32 labels are dropped
(planecluster.cpp:98-167).  Two routes, as in the JAX module: the port's
native C++ core (cartslam_tpu_torch/native) when it builds, else the
Python BFS (``grow_clusters_python``); ``route`` names the one the last
frame took.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..runtime.module import Dependency, HostModule
from .planefit import KEY_PLANES_EQ, RansacDraws, depth_validity, fit_planes


def _adjacency_edges(labels: np.ndarray, num_labels: int) -> np.ndarray:
    """Unique label adjacency edges [E, 2] from the 4 shift comparisons:
    each boundary pair packed into one int64, np.unique once
    (planecluster.cpp:70-93 builds the same graph)."""
    h, w = labels.shape
    lab = labels.astype(np.int64)
    pairs = []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        y0, y1 = max(0, -dy), min(h, h - dy)
        x0, x1 = max(0, -dx), min(w, w - dx)
        a = lab[y0:y1, x0:x1].reshape(-1)
        b = lab[y0 + dy:y1 + dy, x0 + dx:x1 + dx].reshape(-1)
        m = a != b
        a, b = a[m], b[m]
        pairs.append(np.minimum(a, b) * num_labels + np.maximum(a, b))
    uniq = np.unique(np.concatenate(pairs))
    return np.stack([uniq // num_labels, uniq % num_labels], axis=-1)


def _adjacency(labels: np.ndarray, num_labels: int) -> list[set[int]]:
    edges = _adjacency_edges(labels, num_labels)
    neigh: list[set[int]] = [set() for _ in range(num_labels)]
    for x, y in zip(edges[:, 0].tolist(), edges[:, 1].tolist()):
        neigh[x].add(y)
        neigh[y].add(x)
    return neigh


def grow_clusters_python(labels: np.ndarray, planes: np.ndarray, ok: np.ndarray,
                         num_labels: int, min_cluster: int = 32):
    """The Python route of the region growing: (assignments int64 [L],
    cluster planes [C, 4]), the same as native.grow_clusters over
    _adjacency_edges(labels)."""
    # Orientation stats (planecluster.cpp:57-68).
    a, b, c, d = planes.T
    length = np.linalg.norm(planes[:, :3], axis=-1)
    yaw = np.arctan2(b, a)
    pitch = np.arctan2(c, np.maximum(length, 1e-12))
    ys, yc = np.sin(yaw), np.cos(yaw)
    ps, pc = np.sin(pitch), np.cos(pitch)

    neigh = _adjacency(labels, num_labels)
    assignments = np.zeros(num_labels, np.int64)
    clusters: list[np.ndarray] = []

    for seed in range(num_labels):
        if assignments[seed] != 0 or not ok[seed]:
            continue
        similar = [seed]
        seen = {seed}
        frontier = set(neigh[seed])
        while frontier:
            other = frontier.pop()
            seen.add(other)
            if not ok[other]:
                continue
            yaw_diff = abs(ys[seed] - ys[other]) + abs(yc[seed] - yc[other])
            pitch_diff = abs(ps[seed] - ps[other]) + abs(pc[seed] - pc[other])
            d_diff = abs(d[seed] - d[other])
            if yaw_diff < 0.2 and pitch_diff < 0.2 and d_diff < 3:
                cur = assignments[other]
                if cur != 0:
                    # Keep the more similar assignment (planecluster.cpp:131-141).
                    cs = clusters[cur - 1]
                    cy = abs(np.sin(np.arctan2(cs[1], cs[0])) - ys[other]) + abs(
                        np.cos(np.arctan2(cs[1], cs[0])) - yc[other])
                    cl = np.linalg.norm(cs[:3])
                    cp_ = np.arctan2(cs[2], max(cl, 1e-12))
                    cp = abs(np.sin(cp_) - ps[other]) + abs(np.cos(cp_) - pc[other])
                    if cy + cp + d_diff < yaw_diff + pitch_diff + d_diff:
                        continue
                similar.append(other)
                for nb in neigh[other]:
                    if nb not in seen:
                        frontier.add(nb)
        if len(similar) < min_cluster:
            continue
        clusters.append(planes[seed])
        for lab in similar:
            assignments[lab] = len(clusters)
    return assignments, np.array(clusters) if clusters else np.zeros((0, 4))


class SuperPixelPlaneClusterModule(HostModule):
    name = "PlaneCluster"

    def __init__(self, num_labels: int, min_cluster: int = 32, min_points: int = 16,
                 fit_method: str = "ransac"):
        self.num_labels = num_labels
        self.min_cluster = min_cluster
        self.min_points = min_points
        self.fit_method = fit_method
        self.draws = RansacDraws(num_labels)
        self.route: str | None = None  # "native" or "python": the last frame's

    def requires(self):
        return [Dependency("superpixels"), Dependency("depth")]

    def provides_data(self):
        return [KEY_PLANES_EQ]

    def fit(self, ctx, labels: np.ndarray, depth: np.ndarray):
        """([L, 4] float32 planes, [L] counts) of the fetched labels and
        depth, fitted on ctx.device."""
        dev = ctx.device
        with self.device_work(ctx):
            lab = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)
            dep = torch.from_numpy(np.ascontiguousarray(depth)).to(dev)
            draws = self.draws.get(lab.numel(), dev) if self.fit_method == "ransac" else None
            planes, npts = fit_planes(lab, dep, depth_validity(dep), self.num_labels,
                                      self.fit_method, draws)
            return planes.numpy(force=True), npts.numpy(force=True)

    def process(self, ctx, frame_id, frame, fetched, globals_):
        labels = np.asarray(fetched["superpixels"])
        L = self.num_labels
        planes, npts = self.fit(ctx, labels, np.asarray(fetched["depth"]))
        norms = np.linalg.norm(planes[:, :3], axis=-1)
        ok = (npts >= self.min_points) & (norms > 0)
        if native.available():
            # The same region growing the reference runs natively
            # (planecluster.cpp:98-167), over the vectorized edge list.
            self.route = "native"
            assignments, cplanes = native.grow_clusters(
                L, _adjacency_edges(labels, L), planes.astype(np.float64), ok,
                yaw_pitch_thresh=0.2, d_thresh=3.0, min_cluster=self.min_cluster)
            cplanes = cplanes if len(cplanes) else np.zeros((0, 4))
        else:
            self.route = "python"
            assignments, cplanes = grow_clusters_python(labels, planes, ok, L, self.min_cluster)
        planes_eq = {"planes": cplanes, "assignments": assignments}
        globals_[KEY_PLANES_EQ] = planes_eq
        return {KEY_PLANES_EQ: planes_eq}
