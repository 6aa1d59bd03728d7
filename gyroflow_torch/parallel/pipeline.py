"""The frame window, and its sharding over a mesh of torch devices.

Counterpart of gyroflow_tpu.parallel.pipeline. A window of F frames of one
plane is stabilized over a (dp, sp) ``FrameMesh``: frames are data-parallel
over "dp" (each dp row takes F / dp of them, replicated over its sp
columns) and output rows over "sp" (column s computes the band of rows
s * oh / sp .. (s + 1) * oh / sp of each of its row's frames). No band
needs another: each depends only on its frame's matrices (SURVEY §5), so
there are no collectives. The bands assemble into one (F, oh, ow, C)
output on the mesh's first device.

On a CUDA device each (frame, band) runs through ``remap.remap_plane_cuda``
with ``out_rows``/``oy0`` (the coords kernel, the self-contained one for a
plane it admits, then the sampler or EWA kernel, the coordinate math in
absolute output space). On the CPU the
production step runs the plain ``remap.remap_plane`` and takes each band
from the whole plane, as the JAX step does with ``use_pallas=False``;
``stabilize_window_sharded`` and ``use_kernels=True`` run the band route on
CPU tensors too, where the kernel wrappers take their plain versions. A
device may appear more than once in a mesh: such logical shards run one
after another on it, as the JAX tests' virtual host devices do, and hold
the band and frame math on one card or on the CPU.

A window goes to each device of a dp row in one host->device copy of the
row's frames, one of their (F / dp, M, 14) matrix stacks and, for a Sony
clip, one of the (F / dp, L) stack of their mesh / focal-plane buffers
(frame i's remap reads row i). Nothing inside a window reads a device value
back (no ``.item()``, no flag test, no ``.cpu()``); each frame's dynamics
and background still go up as pageable copies, which wait for the stream.

What the JAX module needs the TPU for is not here: the window ladder, the
per-band overflow retry and the XLA fallback exist because a TPU kernel
reads a fixed source window; here one thread per output pixel reads its
taps directly, so nothing can overflow, and no overflow flags are returned.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..ops import remap
from ..ops.kernel_params import KernelConfig, KernelDynamics

_OUT_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16, "f32": torch.float32}


def stack_dynamics(dyns) -> KernelDynamics:
    """Stack per-frame KernelDynamics (host numpy leaves) along a leading F
    axis."""
    return KernelDynamics(*(np.stack([np.asarray(x) for x in xs]) for xs in zip(*dyns)))


def stack_meshes(meshes):
    """The window's per-frame mesh buffers (numpy, or None for a frame
    without one) as one (F, L) float32 array, each padded with zeros to the
    longest (the remap reads a buffer at offsets of its own grid); None when
    no frame has one. The frames of one window share one KernelConfig, so
    either all have a buffer or none."""
    if all(m is None for m in meshes):
        return None
    if any(m is None for m in meshes):
        raise ValueError("a window mixes frames with and without a mesh buffer")
    n = max(len(m) for m in meshes)
    out = np.zeros((len(meshes), n), np.float32)
    for i, m in enumerate(meshes):
        out[i, :len(m)] = np.asarray(m, np.float32).reshape(-1)
    return out


def _frame_dynamics(dyns: KernelDynamics, i: int) -> KernelDynamics:
    return KernelDynamics(*(x[i] for x in dyns))


@dataclass(frozen=True)
class FrameMesh:
    """A (dp, sp) grid of torch devices: ``devices[d][s]`` computes output
    band s of the frames of dp row d. A device may repeat (logical shards)."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The first device: the window's output assembles there."""
        return self.devices[0][0]


def _present_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _device(d) -> torch.device:
    """d as a torch.device; a CUDA device gets its index and must exist."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    d = torch.device("cuda", d.index or 0)
    if d.index >= _present_cards():
        raise RuntimeError(f"no CUDA device {d} ({_present_cards()} present)")
    return d


def make_frame_mesh(n_devices: Optional[int] = None, sp: int = 1, devices=None,
                    device=None) -> FrameMesh:
    """A mesh over ("dp", "sp"): n_devices // sp rows of sp devices.

    By default the devices are the cards cuda:0 .. cuda:n-1 (n_devices=None:
    every card present); fewer cards than asked for raise, and nothing moves
    to the CPU on its own. ``devices`` names them instead, in order (the
    first n_devices of the list; all of it when n_devices is None); a name
    may repeat, e.g. ``["cpu"] * 8`` or ``[torch.device("cuda", 0)] * 4``
    for logical shards on one device. ``device`` names the one device of a
    1 x 1 mesh."""
    if device is not None:
        if devices is not None:
            raise ValueError("give devices or device, not both")
        devices = [device]
    if devices is None:
        present = _present_cards()
        n = present if n_devices is None else n_devices
        if not 1 <= n <= present:
            raise RuntimeError(f"a frame mesh over {n} CUDA devices: {present} present (name "
                               f"the devices, e.g. devices=[\"cpu\"] * {max(n, 1)}, for logical "
                               f"shards)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    n = len(devices) if n_devices is None else n_devices
    if not 1 <= n <= len(devices):
        raise ValueError(f"a frame mesh over {n} devices: {len(devices)} named")
    if sp < 1 or n // sp < 1:
        raise ValueError(f"sp={sp} does not fit {n} devices")
    dp = n // sp
    if len({d.type for d in devices[:dp * sp]}) > 1:
        raise ValueError(f"a frame mesh over devices of more than one type: {devices[:dp * sp]}")
    return FrameMesh(tuple(tuple(devices[r * sp:(r + 1) * sp]) for r in range(dp)))


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _band_rows(cfg: KernelConfig, sp: int) -> int:
    oh = cfg.out_buffer[1]          # plane buffer height (chroma may be oh/2)
    if oh % sp != 0:
        raise ValueError(f"plane output height {oh} not divisible by sp={sp}")
    return oh // sp


def _uses_kernels(mesh: FrameMesh, use_kernels: Optional[bool]) -> bool:
    return mesh.device.type == "cuda" if use_kernels is None else use_kernels


def _backend(mesh: FrameMesh) -> str:
    base = "cuda" if mesh.device.type == "cuda" else "torch-cpu"
    return base + ("-window" if mesh.shape == {"dp": 1, "sp": 1} else "-sharded")


# one step per (mesh, cfg, window, out dtype, route), as gyroflow_tpu's
# _STEP_CACHE holds one compiled program per (mesh, cfg, window, dtype)
_STEP_CACHE: dict = {}


def make_window_step(mesh: FrameMesh, cfg: KernelConfig, f_local: int, out_dtype: str = "f32",
                     use_kernels: Optional[bool] = None):
    """The (cached) window step over mesh.

    Returns step(placed, dyns) -> out: placed from ``place_window`` (f_local
    frames a dp row), dyns a KernelDynamics with host numpy leaves and a
    leading F axis. out is (F, oh, ow, C) on mesh.device in out_dtype
    ("uint8": clip, then truncate; "uint16": rint, then clip to each frame's
    max_pixel_value; "f32"). With the kernels (use_kernels, by default on a
    CUDA mesh) each (frame, band) launches the coords kernel and the sampler
    (or EWA) kernel once on its device; otherwise each frame runs the plain
    remap once per device of its row and each band is cut from it."""
    key = (mesh.devices, cfg, f_local, out_dtype, use_kernels)
    step = _STEP_CACHE.get(key)
    if step is not None:
        return step
    sp = mesh.shape["sp"]
    rows = _band_rows(cfg, sp)
    ow, oh = cfg.out_buffer
    kernels = _uses_kernels(mesh, use_kernels)

    def step(placed, dyns: KernelDynamics):
        if len(placed) != len(mesh.devices) or any(
                x.shape[0] != f_local or m.shape[0] != f_local
                for row in placed for x, m, _ in row.values()):
            raise ValueError(f"window of {f_local} frames a dp row over mesh {mesh.shape}: got "
                             f"{[[tuple(x.shape) for x, _, _ in row.values()] for row in placed]}")
        C = next(iter(placed[0].values()))[0].shape[-1]
        out = torch.empty((len(placed) * f_local, oh, ow, C), dtype=_OUT_DTYPES[out_dtype],
                          device=mesh.device)
        for d, row in enumerate(mesh.devices):
            for i in range(f_local):
                f = d * f_local + i
                dyn = _frame_dynamics(dyns, f)
                whole = {}
                for s, dev in enumerate(row):
                    imgs, mats, meshes = placed[d][dev]
                    mesh_i = None if meshes is None else meshes[i]
                    with _on(dev):
                        if kernels:
                            band = remap.remap_plane_cuda(imgs[i], mats[i], cfg, dyn, mesh_i,
                                                          out_dtype=out_dtype, out_rows=rows,
                                                          oy0=s * rows)
                        else:
                            if dev not in whole:
                                whole[dev] = remap.remap_plane(imgs[i], mats[i], cfg, dyn,
                                                               mesh_i, out_dtype=out_dtype)
                            band = whole[dev][s * rows:(s + 1) * rows]
                    out[f, s * rows:(s + 1) * rows] = band
        return out

    _STEP_CACHE[key] = step
    return step


def place_window(mesh: FrameMesh, imgs, matrices, meshes=None, dtype=None):
    """Put each dp row's frames, matrices and mesh buffers on each device of
    the row, one copy each (a tensor already there is not copied); the
    frames in ``dtype`` where given, converted on the device. Returns one
    dict a dp row, {device: (imgs, matrices, meshes or None)}."""
    imgs = torch.as_tensor(imgs)
    matrices = torch.as_tensor(matrices, dtype=torch.float32)
    if meshes is not None:
        meshes = torch.as_tensor(meshes, dtype=torch.float32)
    dp = mesh.shape["dp"]
    F = imgs.shape[0]
    if F % dp != 0:
        raise ValueError(f"frame window {F} not divisible by dp={dp}")
    if matrices.shape[0] != F or (meshes is not None and meshes.shape[0] != F):
        raise ValueError(f"window of {F} frames: got {tuple(matrices.shape)} matrices")
    f_local = F // dp
    placed = []
    for d, row in enumerate(mesh.devices):
        rows = slice(d * f_local, (d + 1) * f_local)
        on_dev = {}
        for dev in row:
            if dev in on_dev:
                continue
            with trace.span("gf.upload"):
                x = trace.to_device(imgs[rows], dev)
            on_dev[dev] = (x if dtype is None else x.to(dtype),
                           trace.to_device(matrices[rows], dev),
                           None if meshes is None else trace.to_device(meshes[rows], dev))
        placed.append(on_dev)
    return placed


def stabilize_window_production(mesh: FrameMesh, imgs, matrices, cfg: KernelConfig,
                                dyns: KernelDynamics, out_dtype: str = "f32", meshes=None,
                                use_kernels: Optional[bool] = None, in_dtype=None):
    """Stabilize a window of F frames of one plane over mesh.

    imgs (F, H, W, C) uint8, uint16 or float32, matrices (F, M, 14): numpy
    arrays or tensors; dyns with host numpy leaves; meshes None or the
    frames' (F, L) mesh buffers (``stack_meshes``); in_dtype the dtype the
    frames are sampled in (converted on each device). F must divide by dp
    and the plane's output height by sp. Returns (out (F, oh, ow, C) tensor
    on mesh.device, backend): "cuda-window" or "torch-cpu-window" on a 1 x 1
    mesh, "cuda-sharded" or "torch-cpu-sharded" on a larger one."""
    placed = place_window(mesh, imgs, matrices, meshes, in_dtype)
    step = make_window_step(mesh, cfg, imgs.shape[0] // mesh.shape["dp"], out_dtype, use_kernels)
    return step(placed, dyns), _backend(mesh)


def stabilize_window_sharded(mesh: FrameMesh, imgs, matrices, cfg: KernelConfig,
                             dyns: KernelDynamics, meshes=None):
    """Frame-window DP over mesh's "dp" rows, output-row bands over its "sp"
    columns, every band through the kernels (on CPU tensors their plain
    versions): the counterpart of the JAX sharded Pallas window. Returns
    out (F, oh, ow, C) float32 on mesh.device; there is no overflow flag."""
    sp, oh = mesh.shape["sp"], cfg.output_height
    if oh % sp != 0:
        raise ValueError(f"output height {oh} not divisible by sp={sp}")
    out, _ = stabilize_window_production(mesh, imgs, matrices, cfg, dyns, meshes=meshes,
                                         use_kernels=True)
    return out


def stabilize_window(imgs, matrices, cfg: KernelConfig, dyns: KernelDynamics, meshes=None):
    """Stabilize F frames one after another through the plain torch remap
    (no kernel), on imgs' device: the reference the sharded window is held
    to (the JAX package's vmapped XLA window). Returns (F, oh, ow, C)
    float32."""
    imgs = torch.as_tensor(imgs)
    matrices = torch.as_tensor(matrices, dtype=torch.float32)
    return torch.stack([remap.remap_plane(imgs[i], matrices[i], cfg, _frame_dynamics(dyns, i),
                                          None if meshes is None else meshes[i])
                        for i in range(imgs.shape[0])])
