"""Entry points of the port: a one-card step and a sharded dryrun.

Counterpart of the repository's ``__graft_entry__.py``:

- ``entry(device=None)`` returns ``(fn, (img, mats))``: the flagship step
  (per-row rolling-shutter stabilization of a 720p luma plane, fisheye
  model, lanczos4) through ``remap.remap_plane_cuda`` on ``cuda:0`` unless
  the caller names a device (on the CPU the kernel wrappers run their plain
  versions).
- ``dryrun_multichip(n_devices, devices=None)`` runs one sharded window
  step over a ("dp", "sp") mesh of n devices, frames data-parallel and
  output rows in bands: a 128x64 bilinear smoke stage (``smoke_stage``),
  then the production stage (``production_stage``: 1920x1088 luma,
  lanczos4, per-row RS, 10-bit uint16 in and out) on ``dryrun_mesh``.
  It runs on the cards cuda:0 .. cuda:n-1, or on ``devices`` where given
  (a device may repeat: logical shards), and never falls back to the CPU.

    python -m gyroflow_torch.entry        # entry() and dryrun_multichip on the cards
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _make_inputs(W, H, rs_rows=True, seed=0, device="cpu"):
    """A seeded (H, W, 1) float32 luma plane and its (rows, 14) RS matrices
    (one row a line, or one), with the lens focal lengths and fov that made
    them: ``__graft_entry__._make_inputs`` built in numpy, put on device."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W, 1)).astype(np.float32)

    def rotm(rx, ry, rz):
        cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                                  math.sin(ry), math.cos(rz), math.sin(rz))
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return Rz @ Ry @ Rx

    f = (W * 0.62, W * 0.62)
    fov = 0.95
    new_k = np.array([[f[0] / fov, 0, W / 2], [0, f[1] / fov, H / 2], [0, 0, 1.0]])
    rows = []
    for i in range(H if rs_rows else 1):
        r = rotm(0.01 + 2e-5 * i, -0.015, 0.004)
        r[0, 1] *= -1; r[0, 2] *= -1; r[1, 0] *= -1; r[2, 0] *= -1
        rows.append(list(np.linalg.pinv(new_k @ r).flatten()) + [0.0] * 5)
    mats = np.asarray(rows, np.float32)
    return (torch.from_numpy(img).to(device), torch.from_numpy(mats).to(device), f, fov)


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)


def entry(device=None):
    """Returns (fn, example_args): the one-card forward step, fn(img, mats)
    -> (720, 1280, 1) float32 on the inputs' device."""
    from .ops import remap
    from .ops.kernel_params import KernelConfig, KernelDynamics

    dev = _default_device(device)
    W, H = 1280, 720
    img, mats, f, fov = _make_inputs(W, H, device=dev)
    cfg = KernelConfig(width=W, height=H, output_width=W, output_height=H,
                       interpolation=8, distortion_model="opencv_fisheye")
    dyn = KernelDynamics.make(f=f, c=(W / 2, H / 2), k=[0.25, -0.07, 0.02, -0.003], fov=fov)

    def fn(img, mats):
        return remap.remap_plane_cuda(img, mats, cfg, dyn)

    return fn, (img, mats)


def _shards(mesh) -> str:
    """Each shard's (dp, sp) place and its physical device."""
    def name(d):
        return f"{d} ({torch.cuda.get_device_name(d)})" if d.type == "cuda" else str(d)
    return "; ".join(f"({r}, {s}) {name(d)}" for r, row in enumerate(mesh.devices)
                     for s, d in enumerate(row))


def dryrun_mesh(n_devices: int, devices=None):
    """The dryrun's mesh over n devices: sp = 2 when n is even and above 2."""
    from .parallel import make_frame_mesh

    sp = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    return make_frame_mesh(n_devices, sp=sp, devices=devices)


def smoke_stage(mesh) -> None:
    """Stage 1 (smoke, tiny): the sharded kernel window, 128x64 bilinear,
    F = 8, checked and printed with the mesh and each shard's device."""
    from .ops.kernel_params import KernelConfig, KernelDynamics
    from .parallel import stabilize_window_sharded, stack_dynamics

    W, H, F = 128, 64, 8
    img, mats, f, fov = _make_inputs(W, H)
    cfg = KernelConfig(width=W, height=H, output_width=W, output_height=H,
                       interpolation=2, distortion_model="opencv_fisheye")
    dyns = stack_dynamics([
        KernelDynamics.make(f=f, c=(W / 2, H / 2), k=[0.2, -0.05, 0.01, -0.001],
                            fov=fov + 0.01 * i) for i in range(F)])
    out = stabilize_window_sharded(mesh, torch.stack([img] * F), torch.stack([mats] * F), cfg,
                                   dyns)
    assert tuple(out.shape) == (F, H, W, 1), out.shape
    assert out.device == mesh.device, out.device
    assert bool(torch.isfinite(out).all()), "non-finite output"
    print(f"dryrun_multichip smoke OK: {tuple(out.shape)} on mesh {mesh.shape}: {_shards(mesh)}")


def production_stage(mesh) -> None:
    """Stage 2 (production config): the renderer's window step at the bench
    geometry class: 1920x1088 luma, lanczos4, per-row rolling-shutter
    matrices, 10-bit uint16 in and out, F = 8."""
    from .ops.kernel_params import KernelConfig, KernelDynamics
    from .parallel import stabilize_window_production, stack_dynamics

    W, H, F = 1920, 1088, 8
    img, mats, f, fov = _make_inputs(W, H, rs_rows=True, seed=1)
    imgs16 = torch.clamp(torch.stack([img] * F) * (1023.0 / 255.0), 0, 1023).to(torch.uint16)
    cfg = KernelConfig(width=W, height=H, output_width=W, output_height=H,
                       interpolation=8, distortion_model="opencv_fisheye")
    dyns = stack_dynamics([
        KernelDynamics.make(f=f, c=(W / 2, H / 2), k=[0.25, -0.07, 0.02, -0.003],
                            fov=fov + 0.005 * i, max_pixel_value=1023.0,
                            pixel_value_limit=1023.0) for i in range(F)])
    out, backend = stabilize_window_production(mesh, imgs16, torch.stack([mats] * F), cfg, dyns,
                                               out_dtype="uint16")
    assert tuple(out.shape) == (F, H, W, 1), out.shape
    assert out.dtype == torch.uint16
    kind = "cuda" if mesh.device.type == "cuda" else "torch-cpu"
    assert backend == kind + ("-window" if mesh.shape == {"dp": 1, "sp": 1} else "-sharded"), \
        backend
    mx = int(out.to(torch.int32).max())
    assert 0 < mx <= 1023, mx
    print(f"dryrun_multichip OK: {tuple(out.shape)} {out.dtype} lanczos4+per-row-RS 10-bit via "
          f"{backend} on mesh {mesh.shape}: {_shards(mesh)}")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run one sharded stabilization window step on an n-device mesh: the
    smoke stage, then the production stage."""
    mesh = dryrun_mesh(n_devices, devices)
    smoke_stage(mesh)
    production_stage(mesh)


if __name__ == "__main__":
    fn, args = entry()
    print("entry OK:", tuple(fn(*args).shape))
    dryrun_multichip(torch.cuda.device_count())
