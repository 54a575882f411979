"""ctypes bindings of the port to the repository's native runtime library.

A copy of the ``parse_obs_file``, ``lsd_detect`` and ``metric_embedding``
bindings of ``slslam_tpu/native.py`` (:144-213) and of its build lock
(:25-77).  The library is compiled from the repository's
``native/slslam_native.cpp`` with ``g++`` at first use into
``build/native/`` beside the package (git-ignored), never into ``native/``:
the file name carries a hash of the source, so a changed source builds
anew.  Concurrent builders (test workers) serialize on an ``flock`` and
swap the finished library in with an atomic rename.

``available()`` says whether the library loads; ``build_error`` holds why
it did not.  Nothing here falls back: the callers choose their walker or
grower and report it (``engine/embedding.py``, ``frontend/detector.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
SRC_PATH = os.path.join(_REPO_ROOT, "native", "slslam_native.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_tried = False
build_error: Optional[str] = None


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libslslam_native_{h.hexdigest()[:16]}.so")


def _build(lib_path: str):
    """Compile to a temporary file and rename it into place under an
    exclusive lock (slslam_tpu/native.py:25-77): a waiting builder uses what
    the holder produced."""
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.build.{os.getpid()}"
    fd = os.open(lib_path + ".lock", os.O_CREAT | os.O_WRONLY)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise RuntimeError("timed out waiting for the native "
                                       "library's build lock")
                time.sleep(0.1)
        if os.path.exists(lib_path):
            return
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC_PATH], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
        os.close(fd)   # closing releases the flock


def _load():
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        build_error = repr(exc)
        return None
    ip = ctypes.POINTER(ctypes.c_int)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.slslam_parse_obs_file.restype = ctypes.c_int
    lib.slslam_parse_obs_file.argtypes = [ctypes.c_char_p, ip, dp,
                                          ctypes.c_int]
    lib.slslam_metric_embedding.restype = ctypes.c_int
    lib.slslam_metric_embedding.argtypes = [
        ctypes.c_int, ctypes.c_int, ip, ip, dp, ctypes.c_int, ip, dp,
        ctypes.POINTER(ctypes.c_ubyte), dp]
    fp = ctypes.POINTER(ctypes.c_float)
    f = ctypes.c_float
    lib.slslam_lsd_detect.restype = ctypes.c_int
    lib.slslam_lsd_detect.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int,
                                      f, f, f, f, dp, dp, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_obs_file(path: str, max_rows: int = 4096
                   ) -> Optional[Dict[int, np.ndarray]]:
    """Native loader; None if the library is unavailable or the file
    cannot be opened."""
    lib = _load()
    if lib is None:
        return None
    ids = np.zeros(max_rows, np.int32)
    obs = np.zeros((max_rows, 8), np.float64)
    n = lib.slslam_parse_obs_file(
        path.encode(), ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        obs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows)
    if n < 0:
        return None
    return {int(ids[k]): obs[k].copy() for k in range(n)}


def lsd_detect(mag: np.ndarray, angle: np.ndarray, mag_threshold: float,
               angle_tol: float, min_length: float, min_density: float,
               max_segments: int = 4096
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native LSD-style region growing (``slslam_lsd_detect``,
    native/slslam_native.cpp:166-286; the twin of
    ``frontend.detector.LineSegmentDetector._grow_regions``).  Float32
    (H, W) maps in; (segments (N, 4), gradient directions (N, 2)) out, or
    None if the library is unavailable.  The call releases the GIL."""
    lib = _load()
    if lib is None:
        return None
    mag = np.ascontiguousarray(mag, np.float32)
    angle = np.ascontiguousarray(angle, np.float32)
    if mag.ndim != 2 or angle.shape != mag.shape:
        raise ValueError(f"maps of shapes {mag.shape} and {angle.shape}")
    H, W = mag.shape
    segs = np.zeros((max_segments, 4), np.float64)
    grads = np.zeros((max_segments, 2), np.float64)
    fp = ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    n = lib.slslam_lsd_detect(
        mag.ctypes.data_as(fp), angle.ctypes.data_as(fp), H, W,
        mag_threshold, angle_tol, min_length, min_density,
        segs.ctypes.data_as(dp), grads.ctypes.data_as(dp), max_segments)
    return segs[:n].copy(), grads[:n].copy()


def metric_embedding(n_kfs: int, edge_i: np.ndarray, edge_j: np.ndarray,
                     edge_T: np.ndarray, root: int
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Native graph walk.  edge_T: (E, 12) row-major (R, t) per directed
    edge.  Returns (order, T_out (n, 12), distances) or None."""
    lib = _load()
    if lib is None:
        return None
    edge_i = np.ascontiguousarray(edge_i, np.int32)
    edge_j = np.ascontiguousarray(edge_j, np.int32)
    edge_T = np.ascontiguousarray(edge_T, np.float64)
    order = np.zeros(n_kfs, np.int32)
    T_out = np.zeros((n_kfs, 12), np.float64)
    valid = np.zeros(n_kfs, np.uint8)
    dist = np.zeros(n_kfs, np.float64)
    n = lib.slslam_metric_embedding(
        n_kfs, len(edge_i),
        edge_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        edge_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        edge_T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        root,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        T_out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return order[:n], T_out, dist[:n]
