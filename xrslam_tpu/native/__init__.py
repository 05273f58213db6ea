"""ctypes bindings to the native host runtime (native/xr_host.cpp).

The compute path of this framework is JAX/XLA; this library covers the
host-side hot paths around it — PNG decode, undistortion
remap, CSV parsing, IMU stream fusion, Poisson spacing filter — which
the reference runs through OpenCV/stdio on its worker threads.

The .so is built from native/xr_host.cpp on first use
(`make -C native libxr_host.so`; it is never committed); every entry
point has a pure-Python fallback, so the package works without a
toolchain — `available()` says which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lib = None
_lib_lock = threading.Lock()
_tried = False

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO = os.path.join(_NATIVE_DIR, "libxr_host.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) and os.path.exists(
                os.path.join(_NATIVE_DIR, "Makefile")):
            # only the host library: the C ABI target also needs
            # python3-config, which a machine may lack
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, "libxr_host.so"],
                               check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
        if not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None

        c_i = ctypes.c_int
        c_d = ctypes.c_double
        c_f = ctypes.c_float
        c_u8 = ctypes.c_uint8
        c_i64 = ctypes.c_int64
        P = ctypes.POINTER

        lib.xr_png_probe.argtypes = [ctypes.c_char_p, P(c_i), P(c_i)]
        lib.xr_png_probe.restype = c_i
        lib.xr_png_load_gray.argtypes = [ctypes.c_char_p, P(c_f), c_i]
        lib.xr_png_load_gray.restype = c_i
        lib.xr_remap_bilinear.argtypes = [P(c_f), c_i, c_i, P(c_f), P(c_f), P(c_f)]
        lib.xr_remap_bilinear.restype = None
        lib.xr_imu_csv_load.argtypes = [ctypes.c_char_p, P(c_d), P(c_d), P(c_d), c_i]
        lib.xr_imu_csv_load.restype = c_i
        lib.xr_cam_csv_load.argtypes = [ctypes.c_char_p, P(c_d), ctypes.c_char_p, c_i, c_i]
        lib.xr_cam_csv_load.restype = c_i
        lib.xr_fuse_imu.argtypes = [P(c_d), P(c_d), c_i, P(c_d), P(c_d), c_i,
                                    P(c_d), P(c_d), P(c_d)]
        lib.xr_fuse_imu.restype = c_i
        lib.xr_poisson_filter.argtypes = [P(c_d), P(c_i64), P(c_u8), c_i, c_d, P(c_u8)]
        lib.xr_poisson_filter.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# ---------------------------------------------------------------------------


def png_load_gray(path: str) -> Optional[np.ndarray]:
    """(H,W) float32 grayscale in [0,1], or None (fall back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.xr_png_probe(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value), dtype=np.float32)
    rc = lib.xr_png_load_gray(path.encode(), _fp(out, ctypes.c_float),
                              out.size)
    return out if rc == 0 else None


def remap_bilinear(img: np.ndarray, src_u: np.ndarray,
                   src_v: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.float32)
    su = np.ascontiguousarray(src_u, dtype=np.float32)
    sv = np.ascontiguousarray(src_v, dtype=np.float32)
    out = np.empty_like(su)
    lib.xr_remap_bilinear(_fp(img, ctypes.c_float), img.shape[0],
                          img.shape[1], _fp(su, ctypes.c_float),
                          _fp(sv, ctypes.c_float), _fp(out, ctypes.c_float))
    return out


def imu_csv_load(path: str, cap: int = 1 << 22):
    lib = _load()
    if lib is None:
        return None
    t = np.empty((cap,), dtype=np.float64)
    w = np.empty((cap, 3), dtype=np.float64)
    a = np.empty((cap, 3), dtype=np.float64)
    n = lib.xr_imu_csv_load(path.encode(), _fp(t, ctypes.c_double),
                            _fp(w, ctypes.c_double), _fp(a, ctypes.c_double),
                            cap)
    if n < 0:
        return None
    return t[:n].copy(), w[:n].copy(), a[:n].copy()


def cam_csv_load(path: str, cap: int = 1 << 20, name_cap: int = 256):
    lib = _load()
    if lib is None:
        return None
    t = np.empty((cap,), dtype=np.float64)
    names = ctypes.create_string_buffer(cap * name_cap)
    n = lib.xr_cam_csv_load(path.encode(), _fp(t, ctypes.c_double), names,
                            name_cap, cap)
    if n < 0:
        return None
    out = []
    for i in range(n):
        raw = names.raw[i * name_cap:(i + 1) * name_cap]
        out.append((float(t[i]), raw.split(b"\0", 1)[0].decode()))
    return out


def fuse_imu(tg: np.ndarray, wg: np.ndarray, ta: np.ndarray, aa: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    tg = np.ascontiguousarray(tg, dtype=np.float64)
    wg = np.ascontiguousarray(wg, dtype=np.float64)
    ta = np.ascontiguousarray(ta, dtype=np.float64)
    aa = np.ascontiguousarray(aa, dtype=np.float64)
    n_max = len(ta)
    ot = np.empty((n_max,), dtype=np.float64)
    ow = np.empty((n_max, 3), dtype=np.float64)
    oa = np.empty((n_max, 3), dtype=np.float64)
    n = lib.xr_fuse_imu(_fp(tg, ctypes.c_double), _fp(wg, ctypes.c_double),
                        len(tg), _fp(ta, ctypes.c_double),
                        _fp(aa, ctypes.c_double), n_max,
                        _fp(ot, ctypes.c_double), _fp(ow, ctypes.c_double),
                        _fp(oa, ctypes.c_double))
    return ot[:n].copy(), ow[:n].copy(), oa[:n].copy()


def poisson_filter(pts: np.ndarray, order: np.ndarray, keep_ok: np.ndarray,
                   min_dist: float) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    keep = np.ascontiguousarray(keep_ok, dtype=np.uint8)
    accept = np.zeros((len(pts),), dtype=np.uint8)
    lib.xr_poisson_filter(_fp(pts, ctypes.c_double),
                          _fp(order, ctypes.c_int64),
                          _fp(keep, ctypes.c_uint8), len(pts),
                          float(min_dist), _fp(accept, ctypes.c_uint8))
    return accept.astype(bool)
