"""ctypes bindings for the native host runtime (native/runtime.cc).

Reference counterpart: the reference's runtime IS native C++ (ROS node,
Armadillo); the build keeps the device compute path in JAX/XLA and moves the
host-side runtime work — ROS-convention map ingest, the exact EDT + gradient
(replacing per-pose Bresenham searches), entropy maps, and multi-threaded
batch preprocessing that feeds the device — into this C++ library.

The shared library is compiled on first use with g++ (cached next to the
source); everything degrades gracefully to the jitted JAX implementations
when no compiler is available (``available()`` -> False).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "runtime.cc")
_SO = os.path.join(os.path.dirname(_SRC), "libeetruntime.so")

_lock = threading.Lock()
_lib = None
_tried = False

FAR = 1.0e6  # keep in sync with ops/distance.py


def _build() -> str:
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", _SO, _SRC, "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_SO)
            f32p = ctypes.POINTER(ctypes.c_float)
            i8p = ctypes.POINTER(ctypes.c_int8)
            lib.eet_ros_ingest.argtypes = [i8p, ctypes.c_int64, f32p]
            lib.eet_entropy.argtypes = [f32p, ctypes.c_int64, f32p]
            lib.eet_edt2d.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                      f32p, f32p]
            lib.eet_edt2d_batch.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32,
                                            ctypes.c_int32, ctypes.c_float, ctypes.c_float,
                                            ctypes.c_float, f32p, f32p, ctypes.c_int32]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def ros_ingest(raw: np.ndarray) -> np.ndarray:
    """int8 ROS occupancy data -> float data (-1 unknown, else 0..1)."""
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.int8)
    out = np.empty(raw.shape, dtype=np.float32)
    lib.eet_ros_ingest(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                       raw.size, _fp(out))
    return out


def entropy_map(data: np.ndarray) -> np.ndarray:
    """Bernoulli entropy per cell (unknown -> H(0.5))."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float32)
    out = np.empty(data.shape, dtype=np.float32)
    lib.eet_entropy(_fp(data), data.size, _fp(out))
    return out


def edt2d(occ_prob: np.ndarray, occupied_threshold: float, resolution: float):
    """Exact EDT (meters) + gradient for one (H, W) map.

    Returns (dist (H, W), grad (H, W, 2)) matching
    ``DistanceField.from_grid`` semantics (FAR where no obstacle exists).
    """
    lib = _load()
    occ = np.ascontiguousarray(occ_prob, dtype=np.float32)
    h, w = occ.shape
    dist = np.empty((h, w), dtype=np.float32)
    grad = np.empty((h, w, 2), dtype=np.float32)
    lib.eet_edt2d(_fp(occ), h, w, occupied_threshold, resolution, FAR,
                  _fp(dist), _fp(grad))
    return dist, grad


def edt2d_batch(occ_prob: np.ndarray, occupied_threshold: float, resolution: float,
                n_threads: int = 0):
    """Threaded exact EDT over (N, H, W) maps -> (dist (N,H,W), grad (N,H,W,2))."""
    lib = _load()
    occ = np.ascontiguousarray(occ_prob, dtype=np.float32)
    n, h, w = occ.shape
    dist = np.empty((n, h, w), dtype=np.float32)
    grad = np.empty((n, h, w, 2), dtype=np.float32)
    lib.eet_edt2d_batch(_fp(occ), n, h, w, occupied_threshold, resolution, FAR,
                        _fp(dist), _fp(grad), n_threads)
    return dist, grad
