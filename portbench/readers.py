"""Arithmetic the per-layer readers (``metrics/<name>.py``) share.

Each takes a ``trace.TraceData`` and returns a number, or None where the run
has nothing to read (no span of that name, no profiled stretch, no launch of
that kernel): the harness then leaves the metric out of the line. A roofline
share is never made up: no device time, no share.
"""
from __future__ import annotations

from . import roofline
from .trace import is_port_kernel, is_sampler


def span_mean_ms(t, name: str):
    s = t.spans.get(name)
    return sum(s) / len(s) * 1e3 if s else None


def span_ms_per_frame(t, name: str):
    s = t.spans.get(name)
    return sum(s) / t.frames * 1e3 if s and t.frames else None


def launches_per_frame(t):
    d = t.device
    return d.count() / d.frames if d and d.frames and d.count() else None


def eager_device_ms(t):
    d = t.device
    if not d or not d.frames or not d.ops["kernel"]:
        return None
    return d.seconds("kernel", lambda n: not is_port_kernel(n)) / d.frames * 1e3


def roofline_pct(t, part: str):
    """100 x the frame's bound (roofline.frame_work[part]) over the device
    time a frame spends in it: every kernel for "remap", the sampler's
    launches for "sampler"."""
    d = t.device
    if not d or not d.frames:
        return None
    pick = (lambda n: True) if part == "remap" else is_sampler
    spent = d.seconds("kernel", pick) / d.frames
    if spent <= 0:
        return None
    return 100.0 * roofline.bound_s(*t.work[part]) / spent


def device_idle_pct(t):
    """The arithmetic of the port's prod_path_probe.device_busy: the share of
    the profiled wall in which the card ran nothing."""
    d = t.device
    if not d or d.window_s <= 0 or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
