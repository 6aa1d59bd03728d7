"""Build and load the CUDA kernels of ``csrc/`` at first use.

Every ``csrc/*.cu`` is compiled by its own nvcc process, all started
together, and one nvcc call links the objects into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). The library lands in ``gyroflow_torch/build/``, named by a hash of
the sources and flags, so an edited kernel rebuilds and an unchanged one
loads from disk. A failed build raises: there is no fallback.

Flags: sm_90a (Hopper), IEEE division and sqrt (no ``--use_fast_math``: the
fisheye chain needs them), and ``--fmad=false`` so each multiply and add
rounds on its own, as the plain torch ops do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of the nvcc call of this process, if any
build_log = ""            # nvcc's stderr (ptxas -v report when verbose)


class CoordParams(ctypes.Structure):
    """Mirror of ``gf::CoordParams`` (csrc/lens.cuh)."""
    _fields_ = [("k", ctypes.c_float * 12), ("f", ctypes.c_float * 2),
                ("c", ctypes.c_float * 2), ("t3d", ctypes.c_float * 3),
                ("r_limit", ctypes.c_float), ("lrc", ctypes.c_float),
                ("stretch_h", ctypes.c_float), ("stretch_v", ctypes.c_float),
                ("dlp", ctypes.c_float * 16), ("width", ctypes.c_float),
                ("height", ctypes.c_float), ("output_width", ctypes.c_float),
                ("output_height", ctypes.c_float)]


class MeshArgs(ctypes.Structure):
    """Mirror of ``gf::MeshArgs`` (csrc/lens.cuh)."""
    _fields_ = [("data", ctypes.c_void_p), ("block_offset", ctypes.c_int),
                ("gw", ctypes.c_int), ("gh", ctypes.c_int), ("mus", ctypes.c_float * 9),
                ("inv_gw1", ctypes.c_float), ("inv_gh1", ctypes.c_float),
                ("inv_width", ctypes.c_float), ("inv_height", ctypes.c_float)]


class OverlayArgs(ctypes.Structure):
    """Mirror of ``OverlayArgs`` (csrc/overlay.cu)."""
    _fields_ = [("colors", ctypes.c_float * 32), ("maxv", ctypes.c_float),
                ("scale", ctypes.c_float), ("src", ctypes.c_float * 4),
                ("safe", ctypes.c_int), ("rect", ctypes.c_float * 4),
                ("band", ctypes.c_float * 4), ("oy0", ctypes.c_int)]


class SamplerArgs(ctypes.Structure):
    """Mirror of ``gf::SamplerArgs`` (csrc/taps.cuh)."""
    _fields_ = [("bg", ctypes.c_float * 4), ("limit", ctypes.c_float),
                ("src_rect", ctypes.c_int * 4)]


class FusedArgs(ctypes.Structure):
    """Mirror of ``FusedArgs`` (csrc/post_uv.cuh)."""
    _fields_ = [("s", SamplerArgs), ("rotate", ctypes.c_int), ("rot_cos", ctypes.c_float),
                ("rot_sin", ctypes.c_float), ("rot_o", ctypes.c_float * 2),
                ("rot_o2", ctypes.c_float * 2), ("bg_mode", ctypes.c_int),
                ("frame_w", ctypes.c_float), ("frame_h", ctypes.c_float),
                ("map_x", ctypes.c_float * 3), ("map_y", ctypes.c_float * 3)]


class GenArgs(ctypes.Structure):
    """Mirror of ``GenArgs`` (csrc/coords.cu)."""
    _fields_ = [("oy0", ctypes.c_int), ("pos_d", ctypes.c_float * 2),
                ("map_x", ctypes.c_float * 3), ("map_y", ctypes.c_float * 3),
                ("t2d", ctypes.c_float * 2), ("lim", ctypes.c_float)]


class EwaArgs(ctypes.Structure):
    """Mirror of ``EwaArgs`` (csrc/ewa.cu)."""
    _fields_ = [("p", ctypes.c_float * 4), ("q", ctypes.c_float * 4),
                ("bg", ctypes.c_float * 4), ("limit", ctypes.c_float),
                ("inv_eps", ctypes.c_float), ("src_rect", ctypes.c_int * 4)]


class ProbeArgs(ctypes.Structure):
    """Mirror of ``ProbeArgs`` (csrc/probe_sampler.cu)."""
    _fields_ = [("H", ctypes.c_int), ("W", ctypes.c_int), ("Sr", ctypes.c_int),
                ("Sc", ctypes.c_int), ("K", ctypes.c_int), ("P", ctypes.c_int),
                ("bg", ctypes.c_float * 4)]


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libgyroflow_torch_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the gyroflow_torch kernels are built from csrc/ at first use")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.

    verbose adds ``-Xptxas -v`` (registers, shared memory, spills per kernel);
    the report is kept in ``build_log``."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    obj_dir = BUILD_DIR / f"obj.{os.getpid()}"
    obj_dir.mkdir(exist_ok=True)
    nvcc = find_nvcc()
    cus, _ = _sources()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [obj_dir / f"{p.stem}.o" for p in cus]
    t0 = time.perf_counter()
    try:
        # one nvcc per source, all started together, then one link
        cmds = [[nvcc, *compile_flags, *(("-Xptxas", "-v") if verbose else ()),
                 "-c", str(src), "-o", str(obj)] for src, obj in zip(cus, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        errs = [p.communicate()[1] for p in procs]
        build_log = "".join(errs)
        for cmd, p, err in zip(cmds, procs, errs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n"
                                   f"{' '.join(cmd)}\n{err[-6000:]}")
        link = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        build_log += res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code {res.returncode}:\n"
                               f"{' '.join(link)}\n{res.stderr[-6000:]}")
    finally:
        build_seconds = time.perf_counter() - t0
        shutil.rmtree(obj_dir, ignore_errors=True)
    os.replace(tmp, out)          # atomic: a concurrent process never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            L.gf_coords.argtypes = [vp, vp, vp, vp, ci, CoordParams, ci, ci, ci, ci, ci,
                                    vp, vp, vp, vp, MeshArgs]
            L.gf_coords.restype = ci
            L.gf_sampler.argtypes = [vp, ci, ci, ci, ci, vp, vp, vp, ci, ci, ci, vp,
                                     SamplerArgs, vp, vp]
            L.gf_sampler.restype = ci
            L.gf_ewa.argtypes = [vp, ci, ci, ci, ci, vp, vp, vp, vp, vp, ci, ci, EwaArgs, vp,
                                 vp]
            L.gf_ewa.restype = ci
            L.gf_fused.argtypes = [vp, ci, ci, ci, ci, vp, vp, vp, vp, ci, CoordParams, ci,
                                   ci, ci, ci, ci, ci, vp, FusedArgs, vp, vp]
            L.gf_fused.restype = ci
            L.gf_coords_gen.argtypes = [vp, ci, CoordParams, ci, ci, GenArgs, ci, ci, vp, vp, vp,
                                        vp]
            L.gf_coords_gen.restype = ci
            L.gf_coords_gen_ewa.argtypes = [vp, ci, CoordParams, ci, ci, GenArgs,
                                            ctypes.c_float, ci, ci, ci, vp, vp, vp, vp]
            L.gf_coords_gen_ewa.restype = ci
            L.gf_fused_bbox.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, ci, CoordParams, ci, ci,
                                        ci, ci, ci, ci, vp, FusedArgs, vp, vp, vp, vp]
            L.gf_fused_bbox.restype = ci
            L.gf_overlay.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, OverlayArgs, vp, vp]
            L.gf_overlay.restype = ci
            L.gf_window_colsum.argtypes = [vp, ci, ci, vp, vp, ci, ci, ci, vp, vp]
            L.gf_window_colsum.restype = ci
            L.gf_window_colsum_path.argtypes = [vp, ci, ci, ci]
            L.gf_window_colsum_path.restype = ci
            L.gf_probe_sampler.argtypes = [vp, ci, vp, vp, vp, vp, vp, ci, vp, ProbeArgs, ci,
                                           ci, vp, vp]
            L.gf_probe_sampler.restype = ci
            _lib = L
    return _lib
