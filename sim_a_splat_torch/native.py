"""ctypes binding of the host-side C++ geometry and recorder kernels.

The port's own copy of the JAX package's native sources, in
``sim_a_splat_torch/csrc/native/``: ``geometry.cpp`` (a 3-D KD-tree for
ICP correspondences and a triangle BVH for point-to-mesh distance and
ray-parity occupancy) and ``recorder.cpp`` (a multithreaded-deflate
``.npz`` writer).  They are plain C++ with a C interface, compiled with
the reference's command::

    g++ -O3 -shared -fPIC -std=c++17 -pthread geometry.cpp recorder.cpp -lz

into ``sim_a_splat_torch/_build/native/``, named by a hash of the sources,
on first use.  Where no compiler builds them, :func:`available` is False
and the callers (``tools/registration.py``, ``tools/masks.py``,
``utils/episodes.py``) keep their numpy/scipy paths, as the reference's
do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "native" / "geometry.cpp",
           _PKG / "csrc" / "native" / "recorder.cpp")
BUILD_DIR = _PKG / "_build" / "native"
_LIB = None
_TRIED = False
build_error: str | None = None     # why the last build failed, if it did


def _build() -> Path | None:
    global build_error
    h = hashlib.sha256()
    for s in SOURCES:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"_native_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = (["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
           + [str(s) for s in SOURCES] + ["-lz", "-o", str(tmp)])
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
    except subprocess.CalledProcessError as e:
        build_error = e.stderr[-2000:]
        return None
    except (OSError, subprocess.SubprocessError) as e:
        build_error = str(e)
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not all(s.exists() for s in SOURCES):
        global build_error
        build_error = f"sources missing: {[str(s) for s in SOURCES]}"
        return None
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    c_d = ctypes.POINTER(ctypes.c_double)
    c_i = ctypes.POINTER(ctypes.c_int64)
    c_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.sas_kd_build.restype = ctypes.c_void_p
    lib.sas_kd_build.argtypes = [c_d, ctypes.c_int64]
    lib.sas_kd_query.restype = None
    lib.sas_kd_query.argtypes = [ctypes.c_void_p, c_d, ctypes.c_int64, c_i,
                                 c_d]
    lib.sas_kd_free.restype = None
    lib.sas_kd_free.argtypes = [ctypes.c_void_p]
    lib.sas_bvh_build.restype = ctypes.c_void_p
    lib.sas_bvh_build.argtypes = [c_d, ctypes.c_int64, c_i, ctypes.c_int64]
    lib.sas_bvh_distance.restype = None
    lib.sas_bvh_distance.argtypes = [ctypes.c_void_p, c_d, ctypes.c_int64,
                                     c_d, c_i]
    lib.sas_bvh_occupancy.restype = None
    lib.sas_bvh_occupancy.argtypes = [ctypes.c_void_p, c_d, ctypes.c_int64,
                                      c_u8]
    lib.sas_bvh_free.restype = None
    lib.sas_bvh_free.argtypes = [ctypes.c_void_p]
    lib.sas_npz_write.restype = ctypes.c_int64
    lib.sas_npz_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        c_i, c_i, ctypes.POINTER(ctypes.c_void_p), c_i, ctypes.c_int32]
    _LIB = lib
    return lib


def available() -> bool:
    """True when the compiled native library is usable on this host."""
    return _load() is not None


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native geometry library unavailable: "
                           f"{build_error}")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class KDTree:
    """Nearest-neighbour index over (N, 3) points (median-split KD-tree),
    the correspondence queries of ``tools/registration.py``."""

    def __init__(self, points: np.ndarray):
        self._lib = _lib()
        pts = np.ascontiguousarray(points, np.float64)
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(f"expected (N, 3) points, got {pts.shape}")
        self._keep = pts           # the tree points into this buffer
        self._h = self._lib.sas_kd_build(_ptr(pts, ctypes.c_double), len(pts))

    def query(self, q: np.ndarray):
        """→ (dist (M,), index (M,)) of the nearest point for each query."""
        qq = np.ascontiguousarray(np.atleast_2d(q), np.float64)
        if qq.ndim != 2 or qq.shape[1] != 3:
            raise ValueError(f"expected (M, 3) queries, got {qq.shape}")
        m = len(qq)
        idx = np.empty(m, np.int64)
        dist = np.empty(m, np.float64)
        self._lib.sas_kd_query(self._h, _ptr(qq, ctypes.c_double), m,
                               _ptr(idx, ctypes.c_int64),
                               _ptr(dist, ctypes.c_double))
        return dist, idx

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sas_kd_free(h)
            self._h = None


class TriBVH:
    """Triangle BVH: exact point→mesh distance and +z ray-parity occupancy
    (Open3D's ``RaycastingScene.compute_{distance,occupancy}``)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self._lib = _lib()
        v = np.ascontiguousarray(vertices, np.float64)
        f = np.ascontiguousarray(faces, np.int64)
        if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
            raise ValueError(f"bad mesh arrays {v.shape} {f.shape}")
        if f.size and (f.min() < 0 or f.max() >= len(v)):
            raise ValueError("face indices outside the vertex array")
        self._keep = (v, f)
        self._h = self._lib.sas_bvh_build(_ptr(v, ctypes.c_double), len(v),
                                          _ptr(f, ctypes.c_int64), len(f))

    def _points(self, points):
        p = np.ascontiguousarray(np.atleast_2d(points), np.float64)
        if p.ndim != 2 or p.shape[1] != 3:
            raise ValueError(f"expected (M, 3) points, got {p.shape}")
        return p

    def distance(self, points: np.ndarray):
        """→ (dist (M,), nearest triangle index (M,))."""
        p = self._points(points)
        m = len(p)
        dist = np.empty(m, np.float64)
        tri = np.empty(m, np.int64)
        self._lib.sas_bvh_distance(self._h, _ptr(p, ctypes.c_double), m,
                                   _ptr(dist, ctypes.c_double),
                                   _ptr(tri, ctypes.c_int64))
        return dist, tri

    def occupancy(self, points: np.ndarray) -> np.ndarray:
        """→ (M,) bool point-in-mesh (watertight assumption)."""
        p = self._points(points)
        m = len(p)
        out = np.empty(m, np.uint8)
        self._lib.sas_bvh_occupancy(self._h, _ptr(p, ctypes.c_double), m,
                                    _ptr(out, ctypes.c_uint8))
        return out.astype(bool)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sas_bvh_free(h)
            self._h = None


def npz_write(path: str | os.PathLike, arrays: dict, level: int = 6) -> None:
    """Write ``arrays`` (str → ndarray) as a standard ``.npz`` that
    ``np.load`` reads, members deflate-compressed in parallel C++ threads.
    Raises RuntimeError if the native library is unavailable and OSError
    on zip32 overflow (the caller then writes with
    ``np.savez_compressed``)."""
    lib = _lib()

    def contig(v):
        a = np.asarray(v)
        # ascontiguousarray would make a 0-d array (1,); 0-d is contiguous
        return a if a.ndim == 0 else np.ascontiguousarray(a)

    items = [(str(k), contig(v)) for k, v in arrays.items()]
    n = len(items)
    names = (ctypes.c_char_p * n)(*[k.encode() for k, _ in items])
    descrs = (ctypes.c_char_p * n)(
        *[np.lib.format.dtype_to_descr(a.dtype).encode() for _, a in items])
    ndims = np.asarray([a.ndim for _, a in items], np.int64)
    shapes = np.asarray(
        [d for _, a in items for d in a.shape] or [0], np.int64)
    data = (ctypes.c_void_p * n)(*[a.ctypes.data for _, a in items])
    nbytes = np.asarray([a.nbytes for _, a in items], np.int64)
    rc = lib.sas_npz_write(str(path).encode(), n, names, descrs,
                           _ptr(ndims, ctypes.c_int64),
                           _ptr(shapes, ctypes.c_int64), data,
                           _ptr(nbytes, ctypes.c_int64), int(level))
    if rc != 0:
        raise OSError(f"sas_npz_write failed with code {rc}")


__all__ = ["available", "KDTree", "TriBVH", "npz_write"]
