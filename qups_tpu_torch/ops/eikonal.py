"""Eikonal travel-time solver (fast marching), the port of
:mod:`qups_tpu.ops.eikonal`.

QUPS's multistencil fast-marching solver (``src/FMM/functions/msfm2d.c:26``,
``msfm3d.c``, wrapped by ``kern/msfm.m:1-30``): one-way travel-time maps
``T`` with ``|grad T| = 1/F`` through heterogeneous sound-speed maps, which
give the eikonal beamformer its delay tables
(``UltrasoundSystem.bfEikonal``).

The frontier algorithm is sequential, so it runs on the host, float64:

* native C++ (``qups_tpu_torch/csrc/msfm.cpp``, the port's copy of the JAX
  package's solver), built at first use with the host C++ compiler into
  ``qups_tpu_torch/_build/`` by :func:`qups_tpu_torch.ops._nvcc.load_host`;
  a failed build raises with the compiler's output;
* :func:`_msfm_py`, a pure-Python ``heapq`` solver with the same semantics,
  which runs with ``use_native=False`` or where the machine has no C++
  compiler.

Maps for many sources (one per element) are computed in a thread pool: the
native solver releases the GIL through ctypes.
"""
from __future__ import annotations

import ctypes
import heapq
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from . import _nvcc

_LIB = None
_LIB_LOCK = threading.Lock()  # msfm_multi's threads build the library once
_C_D = ctypes.POINTER(ctypes.c_double)
_C_I = ctypes.POINTER(ctypes.c_int64)


def native():
    """The native solver's library (built and loaded once), or None where
    the machine has no host C++ compiler. Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None and _nvcc.host_cxx() is not None:
            lib, _ = _nvcc.load_host("msfm")
            i64, f64, i32 = ctypes.c_int64, ctypes.c_double, ctypes.c_int
            lib.msfm2d.argtypes = [_C_D, i64, i64, f64, _C_I, i64, i32, _C_D]
            lib.msfm3d.argtypes = [_C_D, i64, i64, i64, f64, _C_I, i64, i32, _C_D]
            lib.msfm2d_t0.argtypes = [_C_D, i64, i64, f64, _C_I, _C_D, i64, i32, _C_D]
            lib.msfm3d_t0.argtypes = [_C_D, i64, i64, i64, f64, _C_I, _C_D, i64, i32,
                                      _C_D]
            for fn in (lib.msfm2d, lib.msfm3d, lib.msfm2d_t0, lib.msfm3d_t0):
                fn.restype = None
            _LIB = lib
    return _LIB


def _msfm_py(F: np.ndarray, h: float, src: np.ndarray, order2: bool,
             src_t0=None) -> np.ndarray:
    """Pure-Python fast marching (any dimension), heapq frontier."""
    shape = F.shape
    nd = F.ndim
    T = np.full(shape, np.inf)
    state = np.zeros(shape, np.int8)  # 0 far, 1 band, 2 frozen
    heap = []
    R = 3  # analytic init radius (matches the native solver)
    for si, s in enumerate(src):
        s = tuple(int(v) for v in s)
        f0 = float(F[s]) if F[s] > 0 else 1.0
        ts = float(src_t0[si]) if src_t0 is not None else 0.0
        rng = [np.arange(max(0, s[d] - R), min(shape[d], s[d] + R + 1))
               for d in range(nd)]
        for j in np.stack(np.meshgrid(*rng, indexing="ij"), -1).reshape(-1, nd):
            r = h * np.linalg.norm(j - np.asarray(s))
            if r > R * h:
                continue
            jt = tuple(int(v) for v in j)
            t = ts + r / f0
            if t < T[jt]:
                T[jt] = t
                heapq.heappush(heap, (t, jt))
                state[jt] = 1
    invh2 = 1.0 / (h * h)

    def update(j):
        f = F[j]
        if not f > 0:
            return np.inf
        rhs = 1.0 / (f * f)
        A = B = 0.0
        C = -rhs
        one_d = []
        for d in range(nd):
            t1 = np.inf
            t2 = np.inf
            o2 = False
            for sgn in (-1, 1):
                jj = list(j)
                jj[d] += sgn
                if 0 <= jj[d] < shape[d] and state[tuple(jj)] == 2:
                    tv = T[tuple(jj)]
                    if tv < t1:
                        t1 = tv
                        o2 = False
                        jj2 = list(j)
                        jj2[d] += 2 * sgn
                        if order2 and 0 <= jj2[d] < shape[d] \
                                and state[tuple(jj2)] == 2 \
                                and T[tuple(jj2)] <= tv:
                            t2 = T[tuple(jj2)]
                            o2 = True
            if np.isfinite(t1):
                if o2:
                    a, w = (4 * t1 - t2) / 3.0, 2.25 * invh2
                else:
                    a, w = t1, invh2
                A += w
                B -= 2 * w * a
                C += w * a * a
                one_d.append(a + np.sqrt(rhs / w))
        if A == 0:
            return np.inf
        disc = B * B - 4 * A * C
        if disc < 0:
            return min(one_d)
        return (-B + np.sqrt(disc)) / (2 * A)

    while heap:
        tv, j = heapq.heappop(heap)
        if state[j] == 2:
            continue
        state[j] = 2
        for d in range(nd):
            for sgn in (-1, 1):
                jj = list(j)
                jj[d] += sgn
                jt = tuple(jj)
                if not (0 <= jj[d] < shape[d]) or state[jt] == 2:
                    continue
                tn = update(jt)
                if tn < T[jt]:
                    T[jt] = tn
                    heapq.heappush(heap, (tn, jt))
                    state[jt] = 1
    return T


def msfm(F: np.ndarray, h: float, src, order2: bool = True,
         use_native: Optional[bool] = None, src_t0=None) -> np.ndarray:
    """Travel-time map from source cell(s).

    Args:
      F: speed map [m/s], 2-D ``(n0, n1)`` or 3-D ``(n0, n1, n2)``.
      h: isotropic grid spacing [m] (the reference requires isotropic grids
        too, ``UltrasoundSystem.m:4269-4273``).
      src: (ns, ndim) integer source cell indices.
      order2: use second-order upwind differences.
      use_native: None (the native solver where a host C++ compiler exists,
        else the Python one), True (the native solver, or raise) or False
        (the Python solver).
      src_t0: optional per-source initial times (ns,): wavefront sources,
        each source cell starting at its own time (virtual-source and
        boundary-seeded transmits; default all zero).

    Returns: T [s], float64 host numpy, with T = src_t0 at the sources.

    Example:
        import numpy as np
        from qups_tpu_torch.ops.eikonal import msfm
        F = np.full((41, 41), 1500.0)              # homogeneous speed map
        T = msfm(F, 1e-3, np.array([[20, 20]]))    # source at the center
        # travel time to a corner ~ euclidean distance / c
        d = np.hypot(20, 20) * 1e-3
        assert abs(T[0, 0] - d / 1500.0) / (d / 1500.0) < 0.05
    """
    F = np.ascontiguousarray(F, np.float64)
    src = np.ascontiguousarray(np.atleast_2d(np.asarray(src, np.int64)))
    assert src.shape[1] == F.ndim, (src.shape, F.shape)
    if F.ndim not in (2, 3):
        raise ValueError("F must be 2-D or 3-D")
    if ((src < 0) | (src >= np.asarray(F.shape))).any():
        raise ValueError(f"source cells outside the {F.shape} grid")
    if src_t0 is not None:
        src_t0 = np.ascontiguousarray(
            np.broadcast_to(np.asarray(src_t0, np.float64), (src.shape[0],)))
    lib = native() if use_native in (None, True) else None
    if lib is None:
        if use_native is True:
            raise RuntimeError("the native msfm solver needs a host C++ compiler "
                               "($CXX, c++ or g++) and none is on the PATH")
        return _msfm_py(F, h, src, order2, src_t0)
    T = np.empty(F.shape, np.float64)
    dims = F.shape
    head = (F.ctypes.data_as(_C_D), *dims, ctypes.c_double(h), src.ctypes.data_as(_C_I))
    tail = (src.shape[0], int(order2), T.ctypes.data_as(_C_D))
    if src_t0 is not None:
        fn = lib.msfm2d_t0 if F.ndim == 2 else lib.msfm3d_t0
        fn(*head, src_t0.ctypes.data_as(_C_D), *tail)
    else:
        fn = lib.msfm2d if F.ndim == 2 else lib.msfm3d
        fn(*head, *tail)
    return T


def msfm_multi(F: np.ndarray, h: float, srcs: Sequence, order2: bool = True,
               workers: Optional[int] = None) -> np.ndarray:
    """One travel-time map per source (e.g. per element), run in a thread
    pool (the reference uses a process pool per element,
    ``UltrasoundSystem.m:4295-4299``). Returns (len(srcs), *F.shape)."""
    workers = workers or min(len(srcs), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        maps = list(ex.map(lambda s: msfm(F, h, [s], order2=order2), srcs))
    return np.stack(maps)
