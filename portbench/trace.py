"""Spans on the host clock around the calls into each layer, and the device
trace of a profiled stretch, reduced to what the per-layer readers read.

Spans are taken in the benchmark's own code around the program's entry
points; the program is not instrumented. With tracing off the span calls
cost one attribute test. The profiled stretch runs under ``torch.profiler``
(CPU and CUDA activities); its Chrome trace is read back for every device
event (kernels, copies, memsets) with its start and length, and for the host
ops that ran across each idle gap of the card.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# the port's own kernels (csrc/*.cu), by the names the trace gives them
PORT_KERNELS = ("coords_kernel", "coords_mesh_kernel", "coords_gen_kernel", "sampler_kernel",
                "ewa_kernel", "fused_kernel", "fused_bbox_kernel", "overlay_kernel")
SAMPLER_KERNELS = ("sampler_kernel",)
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "copy"}
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def is_sampler(name: str) -> bool:
    return any(k in name for k in SAMPLER_KERNELS) and "probe_sampler" not in name


class Spans:
    """Host-clock spans by name, in seconds, kept in memory. Off: nothing is
    recorded. ``annotate`` also marks each span in a running profiler."""

    def __init__(self, on: bool = False):
        self.on = on
        self.annotate = False
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.frames = 0            # frames the spans cover

    @contextmanager
    def span(self, name: str):
        with (torch.profiler.record_function(f"portbench.{name}") if self.annotate
              else nullcontext()):
            if not self.on:
                yield
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


@dataclass
class DeviceTrace:
    """A profiled stretch of `frames` frames: its wall (host clock, up to a
    synchronize), the union of device activity, and per device-op name
    (count, seconds) by kind."""
    frames: int
    window_s: float
    busy_s: float
    ops: Dict[str, Dict[str, Tuple[int, float]]]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds(self, kind: str, pick=lambda name: True) -> float:
        return sum(s for name, (_, s) in self.ops[kind].items() if pick(name))

    def count(self) -> int:
        """Device events of every kind."""
        return sum(n for kind in self.ops.values() for n, _ in kind.values())


@dataclass
class TraceData:
    """What a per-layer reader reads: the measured window's spans and frame
    count, the profiled stretch (None where the run had no card) and the
    frame's roofline work (roofline.frame_work)."""
    spans: Dict[str, List[float]]
    frames: int
    device: Optional[DeviceTrace]
    work: dict


def profile_stretch(run, frames: int, sync) -> DeviceTrace:
    """run() under torch.profiler, then sync(); run covers `frames` frames."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, frames, wall)


def reduce_events(events, frames: int, wall: float) -> DeviceTrace:
    dev, host = [], []
    ops: Dict[str, Dict[str, list]] = {"kernel": {}, "copy": {}}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            kind = DEVICE_CATS[cat]
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            n, s = ops[kind].get(e["name"], (0, 0.0))
            ops[kind][e["name"]] = (n + 1, s + float(e["dur"]) * 1e-6)
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["dur"]), e["name"]))
    dev.sort()
    merged = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    return DeviceTrace(frames=frames, window_s=wall, busy_s=busy, ops=ops,
                       gaps=_name_gaps(merged, host))


def _name_gaps(merged, host) -> List[Tuple[str, float]]:
    """The card's idle gaps between device activity, summed by what the host
    was doing across each: the innermost host op over the gap's middle,
    under the benchmark's own span when one is open."""
    if len(merged) < 2 or not host:
        return []
    starts = np.array([h[0] for h in host])
    ends = starts + np.array([h[1] for h in host])
    durs = np.array([h[1] for h in host])
    names = [h[2] for h in host]
    is_span = np.array([n.startswith("portbench.") for n in names])
    sums: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(merged[:-1], merged[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        over = (starts <= mid) & (ends >= mid)
        inner = "host idle"
        if over.any():
            idx = np.flatnonzero(over)
            inner = names[idx[np.argmin(durs[idx])]]
            spans = idx[is_span[idx]]
            if spans.size and names[spans[0]] != inner:
                inner = f"{names[spans[0]]} > {inner}"
        sums[inner] += (b - a) * 1e-6
    return sorted(sums.items(), key=lambda kv: -kv[1])


def breakdown(d: DeviceTrace) -> dict:
    """The ten device ops that took most time and the ten host activities
    across which the card idled longest, in seconds."""
    ops = [(name, s) for kind in d.ops.values() for name, (_, s) in kind.items()]
    ops.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in ops[:10]],
            "idle_gaps": [[n[:160], s] for n, s in d.gaps[:10]]}
