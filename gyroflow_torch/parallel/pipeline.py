"""The frame-window step on one torch device.

Counterpart of the production window of gyroflow_tpu.parallel.pipeline
(make_window_step, stabilize_window_production): a window of F frames of one
plane goes to the device in one host->device copy of the frames and one of
their (F, M, 14) matrix stacks, and each frame runs through
``remap.remap_plane_cuda`` (the coords kernel, then the sampler or EWA
kernel) on a CUDA device, or the plain ``remap.remap_plane`` on the CPU,
into one (F, oh, ow, C) output allocated on the device; a Sony clip's
per-frame mesh / focal-plane buffers go up as one (F, L) stack beside the
matrices, and frame i's remap reads row i. Nothing inside a
window reads a device value back (no ``.item()``, no flag test, no
``.cpu()``); each frame's dynamics and background still go up as pageable
copies, which wait for the stream (pinned buffers are performance work).

What the JAX module needs the TPU for is not here: the window ladder, the
per-band overflow retry and the XLA fallback exist because a TPU kernel
reads a fixed source window; here one thread per output pixel reads its taps
directly, so nothing can overflow. ``stabilize_window`` (the vmapped XLA
fallback) has no counterpart, and frame/row sharding over several cards
(``stabilize_window_sharded``, the "sp" row bands) is ROADMAP queue 1,
item 9: ``make_frame_mesh`` gives the one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

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
    """The devices a window runs on: one card (or the CPU), dp = sp = 1."""
    device: torch.device

    @property
    def shape(self) -> dict:
        return {"dp": 1, "sp": 1}


def make_frame_mesh(n_devices: Optional[int] = None, sp: int = 1, device=None) -> FrameMesh:
    """The window's device: ``device`` (cuda:0 unless the caller names
    another device, or the CPU). A mesh over more than one device raises."""
    if (n_devices or 1) != 1 or sp != 1:
        raise NotImplementedError(
            f"a frame mesh over {n_devices} devices (sp={sp}) is not ported to gyroflow_torch "
            "yet (ROADMAP queue 1, item 9: multi-GPU frame/row sharding)")
    return FrameMesh(torch.device(device) if device is not None else torch.device("cuda", 0))


# one step per (device, cfg, window, out dtype), as gyroflow_tpu's
# _STEP_CACHE holds one compiled program per (mesh, cfg, window, dtype)
_STEP_CACHE: dict = {}


def make_window_step(mesh: FrameMesh, cfg: KernelConfig, f_local: int, out_dtype: str = "f32"):
    """The (cached) window step for mesh.device.

    Returns step(imgs, matrices, dyns, meshes=None) -> out: imgs (F, H, W, C)
    uint8, uint16 or float32 and matrices (F, M, 14) float32 on mesh.device,
    dyns a KernelDynamics with host numpy leaves and a leading F axis,
    meshes None or the (F, L) float32 mesh buffers on mesh.device. out is
    (F, oh, ow, C) in out_dtype ("uint8": clip, then truncate; "uint16":
    rint, then clip to each frame's max_pixel_value; "f32"). A CUDA window
    launches the coords kernel and the sampler (or EWA) kernel once per
    frame."""
    key = (mesh.device, cfg, f_local, out_dtype)
    step = _STEP_CACHE.get(key)
    if step is not None:
        return step
    remap_one = remap.remap_plane_cuda if mesh.device.type == "cuda" else remap.remap_plane
    ow, oh = cfg.out_buffer

    def step(imgs, matrices, dyns: KernelDynamics, meshes=None):
        if imgs.shape[0] != f_local or matrices.shape[0] != f_local \
                or (meshes is not None and meshes.shape[0] != f_local):
            raise ValueError(f"window of {f_local} frames: got {tuple(imgs.shape)} frames and "
                             f"{tuple(matrices.shape)} matrices")
        out = torch.empty((f_local, oh, ow, imgs.shape[-1]), dtype=_OUT_DTYPES[out_dtype],
                          device=mesh.device)
        for i in range(f_local):
            out[i] = remap_one(imgs[i], matrices[i], cfg, _frame_dynamics(dyns, i),
                               None if meshes is None else meshes[i], out_dtype=out_dtype)
        return out

    _STEP_CACHE[key] = step
    return step


def place_window(mesh: FrameMesh, imgs, matrices):
    """Move the window's frames and matrices to mesh.device, one copy each
    (a tensor already there is not copied)."""
    return (torch.as_tensor(imgs).to(mesh.device),
            torch.as_tensor(matrices, dtype=torch.float32).to(mesh.device))


def stabilize_window_production(mesh: FrameMesh, imgs, matrices, cfg: KernelConfig,
                                dyns: KernelDynamics, out_dtype: str = "f32", meshes=None):
    """Stabilize a window of F frames of one plane on mesh.device.

    imgs (F, H, W, C) uint8, uint16 or float32, matrices (F, M, 14): numpy
    arrays or tensors; dyns with host numpy leaves; meshes None or the
    frames' (F, L) mesh buffers (``stack_meshes``), uploaded in one copy.
    Returns (out (F, oh, ow, C) tensor on mesh.device, backend):
    "cuda-window" or "torch-cpu-window"."""
    imgs, matrices = place_window(mesh, imgs, matrices)
    if meshes is not None:
        meshes = torch.as_tensor(meshes, dtype=torch.float32).to(mesh.device)
    step = make_window_step(mesh, cfg, imgs.shape[0], out_dtype)
    backend = "cuda" if mesh.device.type == "cuda" else "torch-cpu"
    return step(imgs, matrices, dyns, meshes), backend + "-window"
