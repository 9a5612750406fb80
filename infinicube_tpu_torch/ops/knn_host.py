"""Host-side KD-tree KNN; counterpart of ``infinicube_tpu/ops/knn_host.py``.

``knn_query(query [N, 3], ref [M, 3], k) -> (sq_dist f32 [N, k], idx int32
[N, k])`` over numpy arrays. The tree is ``native/kdtree.cpp``, built with
``g++`` into ``_build/`` at first use (named by a hash of the source) and
bound with ``ctypes``; a failed build raises. ``backend="scipy"`` asks for
scipy's ``cKDTree`` instead, which the tests use as the oracle. Fewer than
64 references are searched by brute force."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "kdtree.cpp"
_BUILD_DIR = _PKG / "_build"
_lib = None


def _target() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libkdtree-{key}.so"


def _load():
    """The built tree library (built here if it is not yet)."""
    global _lib
    if _lib is not None:
        return _lib
    so = _target()
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o",
                               str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [f32, ctypes.c_int64]
    lib.kdtree_query.restype = None
    lib.kdtree_query.argtypes = [ctypes.c_void_p, f32, ctypes.c_int64,
                                 ctypes.c_int32, f32, i32]
    lib.kdtree_free.restype = None
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class KDTree:
    """A tree over ``points`` [M, 3]; ``query`` returns squared distances
    and indices of the k nearest, nearest first (1e30 and -1 past M)."""

    def __init__(self, points: np.ndarray, backend: str = "native"):
        self._h = None
        self._scipy = None
        if backend not in ("native", "scipy"):
            raise ValueError(f"unknown backend {backend!r}")
        self.ref = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        if backend == "native":
            self._lib = _load()
            self._h = self._lib.kdtree_build(self.ref, len(self.ref))
        else:
            from scipy.spatial import cKDTree
            self._scipy = cKDTree(self.ref)

    def query(self, queries: np.ndarray, k: int = 1):
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        if self._h:
            d = np.empty((len(q), k), np.float32)
            i = np.empty((len(q), k), np.int32)
            self._lib.kdtree_query(self._h, q, len(q), k, d, i)
            return d, i
        d, i = self._scipy.query(q, k=k)
        d = np.atleast_2d(d ** 2).reshape(len(q), k).astype(np.float32)
        i = np.atleast_2d(i).reshape(len(q), k).astype(np.int32)
        return d, i

    def close(self):
        if self._h:
            self._lib.kdtree_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def knn_query(query: np.ndarray, ref: np.ndarray, k: int = 1,
              backend: str = "native"):
    """One-shot query: (sq_dist [N, k], idx [N, k])."""
    if len(ref) < 64:
        d = np.sum((query[:, None, :] - ref[None]) ** 2, -1)
        idx = np.argsort(d, axis=1)[:, :k]
        return np.take_along_axis(d, idx, 1).astype(np.float32), \
            idx.astype(np.int32)
    tree = KDTree(ref, backend)
    try:
        return tree.query(query, k)
    finally:
        tree.close()
