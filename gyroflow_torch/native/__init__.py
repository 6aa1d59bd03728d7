"""Native (C++) hot-loop acceleration with transparent Python fallback.

Compiles gyroflow_native.cpp with g++ at first import (cached next to the
source as a versioned .so) and exposes ctypes wrappers. Every entry point has
a pure-Python equivalent; tests assert bit-level agreement.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger(__name__)

_LIB = None
_TRIED = False


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("GYROFLOW_TORCH_NO_NATIVE"):
        return None
    src = os.path.join(os.path.dirname(__file__), "gyroflow_native.cpp")
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        cache_dir = os.environ.get("GYROFLOW_TORCH_NATIVE_CACHE",
                                   os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                                "build", "native"))
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"gyroflow_native_{digest}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".build{os.getpid()}"
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-pthread", "-o", tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            if res.returncode != 0:
                log.warning("native build failed, using Python fallbacks:\n%s",
                            res.stderr[:2000])
                return None
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        dptr = ctypes.POINTER(ctypes.c_double)
        lib.slerp_scan.argtypes = [dptr, ctypes.c_int64, dptr, ctypes.c_int]
        lib.ema_scan.argtypes = [dptr, ctypes.c_int64, ctypes.c_int64, dptr, ctypes.c_int]
        lib.per_axis_scan.argtypes = [dptr, ctypes.c_int64, dptr, ctypes.c_int]
        lib.vqf_offline.argtypes = [dptr, dptr, ctypes.c_int64, ctypes.c_double,
                                    dptr, dptr]
        iptr = ctypes.POINTER(ctypes.c_int)
        lib.ljpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_uint16),
                                     ctypes.c_int64, iptr, iptr, iptr]
        lib.ljpeg_decode.restype = ctypes.c_int
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.ref_cpu_remap_anchor.argtypes = [
            fptr, ctypes.c_int, ctypes.c_int, fptr, ctypes.c_int, fptr,
            fptr, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _LIB = lib
        log.debug("native library loaded: %s", so_path)
    except Exception as e:  # noqa: BLE001 — any failure -> Python fallback
        log.warning("native library unavailable (%s); using Python fallbacks", e)
        _LIB = None
    return _LIB


def available() -> bool:
    return _build_and_load() is not None


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def slerp_scan(quats: np.ndarray, alphas: np.ndarray, reverse: bool) -> np.ndarray:
    lib = _build_and_load()
    out = np.ascontiguousarray(quats, dtype=np.float64).copy()
    a = np.ascontiguousarray(np.broadcast_to(alphas, (out.shape[0],)), dtype=np.float64)
    lib.slerp_scan(_as_c(out), out.shape[0], _as_c(a), 1 if reverse else 0)
    return out


def ema_scan(vals: np.ndarray, alphas: np.ndarray, reverse: bool) -> np.ndarray:
    lib = _build_and_load()
    v = np.ascontiguousarray(vals, dtype=np.float64).copy()
    flat = v.reshape(v.shape[0], -1)
    a = np.ascontiguousarray(np.broadcast_to(alphas, (v.shape[0],)), dtype=np.float64)
    lib.ema_scan(_as_c(flat), flat.shape[0], flat.shape[1], _as_c(a),
                 1 if reverse else 0)
    return v


def per_axis_scan(quats: np.ndarray, factors: np.ndarray, reverse: bool) -> np.ndarray:
    lib = _build_and_load()
    out = np.ascontiguousarray(quats, dtype=np.float64).copy()
    f = np.ascontiguousarray(factors, dtype=np.float64)
    lib.per_axis_scan(_as_c(out), out.shape[0], _as_c(f), 1 if reverse else 0)
    return out


def vqf_offline(gyr: np.ndarray, acc: np.ndarray, ts: float, params_vec: np.ndarray) -> np.ndarray:
    lib = _build_and_load()
    g = np.ascontiguousarray(gyr, dtype=np.float64)
    a = np.ascontiguousarray(acc, dtype=np.float64)
    pp = np.ascontiguousarray(params_vec, dtype=np.float64)
    out = np.empty((g.shape[0], 4), dtype=np.float64)
    lib.vqf_offline(_as_c(g), _as_c(a), g.shape[0], ts, _as_c(pp), _as_c(out))
    return out


def ljpeg_decode(data: bytes) -> np.ndarray:
    """Lossless-JPEG (SOF3) stream -> (H, W, C) uint16. Native when the C++
    library built; utils.ljpeg pure-Python otherwise."""
    lib = _build_and_load()
    if lib is None:
        from ..utils.ljpeg import decode
        return decode(data)
    w = ctypes.c_int()
    h = ctypes.c_int()
    nc = ctypes.c_int()
    rc = lib.ljpeg_decode(data, len(data), None, 0,
                          ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc))
    if rc != 1:
        raise ValueError(f"ljpeg: malformed stream (rc={rc})")
    if h.value * w.value * nc.value > 512 << 20:    # 512M samples sanity cap
        raise ValueError("ljpeg: implausible image dimensions")
    out = np.empty((h.value, w.value, nc.value), np.uint16)
    rc = lib.ljpeg_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(nc))
    if rc != 0:
        raise ValueError(f"ljpeg: decode failed (rc={rc})")
    return out


def ref_cpu_remap_anchor(img: np.ndarray, mats: np.ndarray, params,
                         nthreads: int = 0) -> np.ndarray:
    """Reference-CPU-path performance anchor (BASELINE.md): one plane through
    the cpu_undistort.rs per-pixel workload (center probe + row matrix +
    fisheye distort + lanczos4 8x8 LUT taps), multithreaded. Measurement
    harness only — the production pipeline is the Pallas path."""
    lib = _build_and_load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    im = np.ascontiguousarray(img, dtype=np.float32)
    m = np.ascontiguousarray(mats, dtype=np.float32)
    p = np.ascontiguousarray(params, dtype=np.float32)
    assert m.ndim == 2 and m.shape[1] == 14 and p.size == 10
    out = np.empty_like(im)
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.ref_cpu_remap_anchor(
        im.ctypes.data_as(fptr), im.shape[0], im.shape[1],
        m.ctypes.data_as(fptr), m.shape[0], p.ctypes.data_as(fptr),
        out.ctypes.data_as(fptr), out.shape[0], out.shape[1], nthreads)
    return out
