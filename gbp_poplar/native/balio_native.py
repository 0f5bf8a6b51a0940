"""ctypes bindings for the native BAL loader (balio.cpp).

Builds `_balio.so` with the system g++ on first use (cached next to this
file; falls back to a per-user temp dir if the package directory is
read-only). Raises ImportError when no toolchain is available — callers
(utils/balio.load_bal) then use the NumPy parser.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "balio.cpp")
_LIB_NAME = "_balio.so"

_lib = None


def _build(out_path: str) -> None:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", out_path, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    candidates = [
        os.path.join(os.path.dirname(__file__), _LIB_NAME),
        os.path.join(tempfile.gettempdir(),
                     f"gbp_poplar_{os.getuid()}_{_LIB_NAME}"),
    ]
    lib_path = None
    for cand in candidates:
        if os.path.exists(cand) and os.path.getmtime(cand) >= os.path.getmtime(_SRC):
            lib_path = cand
            break
    if lib_path is None:
        for cand in candidates:
            try:
                _build(cand)
                lib_path = cand
                break
            except (OSError, subprocess.CalledProcessError):
                continue
    if lib_path is None:
        raise ImportError("could not build native BAL loader (no g++?)")

    lib = ctypes.CDLL(lib_path)
    lib.gbp_bal_open.restype = ctypes.c_void_p
    lib.gbp_bal_open.argtypes = [ctypes.c_char_p]
    lib.gbp_bal_header.restype = None
    lib.gbp_bal_header.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_double)]
    lib.gbp_bal_fill.restype = None
    lib.gbp_bal_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.gbp_bal_close.restype = None
    lib.gbp_bal_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def load(path: str):
    """Parse a BAL file natively; returns a utils.balio.BAProblem."""
    from ..utils.balio import BAProblem

    lib = _load_lib()
    handle = lib.gbp_bal_open(path.encode())
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
        lib.gbp_bal_fill(
            handle,
            cam_idx.ctypes.data_as(ctypes.c_void_p),
            lmk_idx.ctypes.data_as(ctypes.c_void_p),
            meas.ctypes.data_as(ctypes.c_void_p),
            cam_means.ctypes.data_as(ctypes.c_void_p),
            lmk_means.ctypes.data_as(ctypes.c_void_p),
        )
    finally:
        lib.gbp_bal_close(handle)
    fx, fy, cx, cy = k4[0], k4[1], k4[2], k4[3]
    k = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    return BAProblem(
        n_keyframes=n_kf, n_points=n_pts, n_edges=n_edges, k=k,
        cam_idx=cam_idx, lmk_idx=lmk_idx, measurements=meas,
        cam_means=cam_means, lmk_means=lmk_means,
    )
