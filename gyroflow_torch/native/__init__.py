"""Native (C++) hot-loop acceleration with transparent Python fallback.

Compiles gyroflow_native.cpp and ft_rows.cpp with g++ at first use into one
library, cached under gyroflow_torch/build/native and named by a digest of both
sources, and exposes ctypes wrappers. Every entry point has a pure-Python
equivalent; tests assert bit-level agreement. ft_rows.cpp builds with
contraction off so that its float64 arithmetic rounds as numpy's does.
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

_HERE = os.path.dirname(__file__)
# each source with the flags it adds to the common ones
SOURCES = {
    os.path.join(_HERE, "gyroflow_native.cpp"): [],
    os.path.join(_HERE, "ft_rows.cpp"): ["-ffp-contract=off", "-fno-fast-math"],
}
COMMON_FLAGS = ["-O3", "-march=native", "-fPIC", "-pthread"]


def digest(sources=SOURCES) -> str:
    """The library's name: a hash of every source and its flags."""
    h = hashlib.sha256()
    for src, flags in sources.items():
        with open(src, "rb") as f:
            h.update(f.read())
        h.update(" ".join(COMMON_FLAGS + flags).encode() + b"\0")
    return h.hexdigest()[:16]


def _build(so_path: str) -> bool:
    """Compile each source to an object with its flags, then link them."""
    tmp = so_path + f".build{os.getpid()}"
    objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
    cmds = [["g++", *COMMON_FLAGS, *flags, "-c", "-o", obj, src]
            for obj, (src, flags) in zip(objs, SOURCES.items())]
    try:
        for cmd in cmds + [["g++", "-shared", "-pthread", "-o", tmp, *objs]]:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            if res.returncode != 0:
                log.warning("native build failed, using Python fallbacks:\n%s",
                            res.stderr[:2000])
                return False
        os.replace(tmp, so_path)
        return True
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)


def _build_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("GYROFLOW_TORCH_NO_NATIVE"):
        return None
    try:
        cache_dir = os.environ.get("GYROFLOW_TORCH_NATIVE_CACHE",
                                   os.path.join(os.path.dirname(_HERE), "build", "native"))
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"gyroflow_native_{digest()}.so")
        if not os.path.exists(so_path) and not _build(so_path):
            return None
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
        i64, vp = ctypes.c_int64, ctypes.c_void_p     # vp: an array's .ctypes.data
        lib.gf_ft_rows.argtypes = [i64, vp, vp, vp, vp, i64, vp, vp, i64, vp, vp, i64,
                                   vp, vp, i64, i64, vp, vp, i64, i64, vp]
        lib.gf_ft_rows.restype = None
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


def ft_rows(rows: int, frame, consts, offsets, org, smoothed, ibis, ois) -> np.ndarray:
    """The FrameTransform's (rows, 14) float32 table (ft_rows.cpp). frame
    and consts are the float64 vectors ft_rows.cpp describes; offsets is a
    pair (int64 us keys, float64 ms values), org and smoothed are pairs (int64
    us, (n, 4) float64 quaternions); ibis and ois are (positions, (n, dim)
    values) of the splines."""
    lib = _build_and_load()
    f64 = lambda a: np.ascontiguousarray(a, dtype=np.float64)    # noqa: E731
    i64 = lambda a: np.ascontiguousarray(a, dtype=np.int64)      # noqa: E731
    arrays = [f64(frame), f64(consts)]    # kept alive through the call
    if arrays[0].shape != (16,) or arrays[1].shape != (18,):
        raise ValueError("ft_rows: frame takes 16 values and consts 18")
    args = [rows, arrays[0].ctypes.data, arrays[1].ctypes.data]
    for (keys, vals), shape in ((offsets, ()), (org, (4,)), (smoothed, (4,))):
        arrays += [i64(keys), f64(vals)]
        if arrays[-2].ndim != 1 or arrays[-1].shape != arrays[-2].shape + shape:
            raise ValueError("ft_rows: keys and values of different lengths")
        args += [arrays[-2].ctypes.data, arrays[-1].ctypes.data, len(arrays[-2])]
    for (pos, vals), cols in ((ibis, 3), (ois, 2)):
        arrays += [f64(pos), f64(vals)]
        if arrays[-1].size and (arrays[-1].ndim != 2 or arrays[-1].shape[1] < cols or
                                arrays[-1].shape[0] != arrays[-2].shape[0]):
            raise ValueError(f"ft_rows: a spline needs (n, >= {cols}) values at n positions")
        args += [arrays[-2].ctypes.data, arrays[-1].ctypes.data, len(arrays[-2]),
                 arrays[-1].shape[1] if arrays[-1].ndim == 2 else 0]
    out = np.empty((rows, 14), np.float32)
    lib.gf_ft_rows(*args, out.ctypes.data)
    return out
