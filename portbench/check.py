"""The comparison that decides ``correct``.

After the window, a seeded sample of the frames the timed path finished
(``loops.Sample``) is recomputed by the plain reference from the same inputs:
the telemetry file, the lens profile and the same host frames. The reference
loads the clip itself (parsing, integration, smoothing, adaptive zoom), builds
each sampled frame's transform at its timestamp and remaps both planes in
plain torch float32 on the same device. Two numbers are compared per frame,
each against the configuration's limit (``check_limits``):

- ``max_code_diff``: the largest |program - reference| over both planes, in
  10-bit codes;
- ``mismatch_ppm``: the pixel values of both planes on which they differ at
  all, per million.

A frame over either limit has failed; the run is correct when it compared at
least one frame and none failed. The control (``calibrate.py`` only; the
benchmark's runs do not run it) puts the reference itself in bfloat16
(``remap_plane_bf16``) in the program's place, on the same frames.
"""
from __future__ import annotations

import numpy as np
import torch

from . import deploy

NUMBERS = ("max_code_diff", "mismatch_ppm")


def frame_numbers(out, ref) -> dict:
    """The two numbers of one frame: out and ref are (Y, UV) pairs, host
    uint16 arrays or uint16 tensors."""
    diff_max, mismatched, total = 0, 0, 0
    for o, r in zip(out, ref):
        r = torch.as_tensor(r).to(torch.int32)
        o = torch.as_tensor(np.asarray(o).astype(np.int32)).to(r.device) \
            if not isinstance(o, torch.Tensor) else o.to(r.device, torch.int32)
        if o.shape != r.shape:
            raise ValueError(f"output of shape {tuple(o.shape)}, reference {tuple(r.shape)}")
        d = (o - r).abs()
        diff_max = max(diff_max, int(d.max()))
        mismatched += int((d > 0).sum())
        total += d.numel()
    return {"max_code_diff": diff_max, "mismatch_ppm": mismatched * 1e6 / max(total, 1)}


def reference_frame(ref, cfg: dict, traffic: dict, pool: list, item, lowp: bool = False):
    """The reference's (Y, UV) output of one sampled frame (index, ts_us, _)."""
    index, ts_us, _ = item
    maxv = float((1 << cfg["bit_depth"]) - 1)
    bgs = ref.plane_backgrounds()
    frame = pool[index % len(pool)]
    ft = ref.frame_transform(ts_us)
    return tuple(ref.stabilize_plane(ft, plane, gi, traffic["interpolation"], maxv, bgs[gi],
                                     lowp=lowp)
                 for gi, plane in enumerate((frame.y, frame.uv)))


def verdict(per_frame: list, limits: dict) -> dict:
    worst = {k: max((f[k] for f in per_frame), default=float("nan")) for k in NUMBERS}
    failed = sum(any(f[k] > limits[k] for k in NUMBERS) for f in per_frame)
    return {"correct": bool(per_frame) and failed == 0, "failed": failed,
            "frames": len(per_frame), "per_frame": per_frame,
            "numbers": {k: {"value": worst[k], "limit": limits[k]} for k in NUMBERS}}


def compare(cfg: dict, traffic: dict, telemetry, pool: list, items: list, device,
            control: bool = False) -> dict:
    """Hold the sampled frames against the reference. With control, also
    hold the control's output of the same frames, under "control"."""
    ref = deploy.reference_stabilizer(cfg, telemetry, device)
    limits = cfg["check_limits"]
    program, lowp = [], []
    for item in items:
        ref_out = reference_frame(ref, cfg, traffic, pool, item)
        program.append(frame_numbers(item[2], ref_out))
        if control:
            lowp.append(frame_numbers(reference_frame(ref, cfg, traffic, pool, item, lowp=True),
                                      ref_out))
        del ref_out
    res = verdict(program, limits)
    if control:
        res["control"] = verdict(lowp, limits)
    return res
