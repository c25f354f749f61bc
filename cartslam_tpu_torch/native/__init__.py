"""ctypes bindings for the port's native host library (counterpart of
cartslam_tpu/native/__init__.py, with the port's own copy of the source).

The region growing of SuperPixelPlaneClusterModule over the superpixel
adjacency (the reference's planecluster.cpp:98-167) runs as a small C++
core, built with g++ at first use (native/build.py).  Where no toolchain
builds it, ``available()`` is False and the module takes its Python route.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    from .build import build

    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:
        logging.getLogger("cart.native").warning("native library unavailable: %s", e)
        return None
    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
    lib.cart_grow_clusters.restype = ctypes.c_int64
    lib.cart_grow_clusters.argtypes = [
        ctypes.c_int64, i64p, i64p, ctypes.c_int64, f64p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, i64p, f64p, ctypes.c_int64,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def grow_clusters(num_labels: int, edges: np.ndarray, planes: np.ndarray, ok: np.ndarray,
                  yaw_pitch_thresh: float = 0.2, d_thresh: float = 3.0,
                  min_cluster: int = 32):
    """Native region growing over edges [E, 2] int64, planes [L, 4] and
    ok [L] bool; returns (assignments int64 [L], cluster planes [C, 4]
    float64).  Raises RuntimeError if the library is unavailable (check
    available())."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available")
    if planes.shape != (num_labels, 4) or ok.shape != (num_labels,) or edges.ndim != 2:
        raise ValueError(f"planes {planes.shape}, ok {ok.shape}, edges {edges.shape} for "
                         f"{num_labels} labels")
    ea = np.ascontiguousarray(edges[:, 0], np.int64)
    eb = np.ascontiguousarray(edges[:, 1], np.int64)
    pl = np.ascontiguousarray(planes, np.float64)
    okc = np.ascontiguousarray(ok, np.uint8)
    assignments = np.zeros(num_labels, np.int64)
    cplanes = np.zeros((num_labels, 4), np.float64)
    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
    n = lib.cart_grow_clusters(
        num_labels, ea.ctypes.data_as(i64p), eb.ctypes.data_as(i64p), len(ea),
        pl.ctypes.data_as(f64p), okc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        float(yaw_pitch_thresh), float(d_thresh), int(min_cluster),
        assignments.ctypes.data_as(i64p), cplanes.ctypes.data_as(f64p), num_labels,
    )
    return assignments, cplanes[:n]
