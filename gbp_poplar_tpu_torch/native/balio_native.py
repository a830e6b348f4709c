"""ctypes binding of the native BAL parser (native/balio.cpp).

The library is built with the system g++ on first use, into
``gbp_poplar_tpu_torch/_build/`` (listed in .gitignore) beside the CUDA
kernels, keyed by a hash of the source and the flags as ops/_cuda.py keys
its build: a changed source rebuilds, an unchanged one loads at once. The
build writes to a temporary name and renames, so concurrent first uses do
not see a half-written library. Nothing here runs at import.

``load(path)`` parses the TUM layout strictly and raises ValueError for
anything else; utils/balio.load_bal routes the other layouts and
compressed files to its NumPy parser. ``load.calls`` counts the files
parsed here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ..ops._cuda import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "balio.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def library() -> ctypes.CDLL:
    """The parser library, built on first call. Raises RuntimeError with
    the compiler's output if the build fails (or OSError without g++)."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libbalio-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
            tmp = os.path.join(tmpdir, "libbalio.so")
            cmd = ["g++", *CXX_FLAGS, "-o", tmp, SRC]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.gbp_bal_open.restype = p
    lib.gbp_bal_open.argtypes = [ctypes.c_char_p]
    lib.gbp_bal_header.restype = None
    lib.gbp_bal_header.argtypes = [p, ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_double)]
    lib.gbp_bal_fill.restype = None
    lib.gbp_bal_fill.argtypes = [p] * 6
    lib.gbp_bal_close.restype = None
    lib.gbp_bal_close.argtypes = [p]
    _lib = lib
    return lib


def load(path: str):
    """Parse a TUM-layout BAL file natively into a utils.balio.BAProblem;
    ValueError if the strict parse refuses it."""
    from ..utils.balio import BAProblem

    lib = library()
    handle = lib.gbp_bal_open(os.fsencode(path))
    if not handle:
        raise ValueError(f"native BAL parse failed: {path}")
    try:
        hdr = (ctypes.c_int64 * 3)()
        k4 = (ctypes.c_double * 4)()
        lib.gbp_bal_header(handle, hdr, k4)
        n_kf, n_pts, n_edges = int(hdr[0]), int(hdr[1]), int(hdr[2])
        cam_idx = np.empty(n_edges, np.uint32)
        lmk_idx = np.empty(n_edges, np.uint32)
        meas = np.empty((n_edges, 2), np.float64)
        cam_means = np.empty((n_kf, 6), np.float64)
        lmk_means = np.empty((n_pts, 3), np.float64)
        lib.gbp_bal_fill(handle, *(a.ctypes.data_as(ctypes.c_void_p) for a in
                                   (cam_idx, lmk_idx, meas, cam_means,
                                    lmk_means)))
    finally:
        lib.gbp_bal_close(handle)
    fx, fy, cx, cy = k4
    load.calls += 1
    return BAProblem(
        n_keyframes=n_kf, n_points=n_pts, n_edges=n_edges,
        k=np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]),
        cam_idx=cam_idx, lmk_idx=lmk_idx, measurements=meas,
        cam_means=cam_means, lmk_means=lmk_means)


load.calls = 0
