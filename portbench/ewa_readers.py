"""What the per-layer readers of the EWA route (``metrics/ewa_*.preview.py``
and ``metrics/coords_points_per_frame.preview.py``) share.

They read the program's own tracer (``gyroflow_torch.trace``) after the
profiled stretch, as ``program_trace.py`` does, and only a tracer with named
counters (``counts()``): the program that has them also names the EWA
route's spans (``gf.ewa.stack``, ``gf.ewa.sample``) and counts the positions
its coords launches project (``gf.coords.points``). Each function returns
None where there is nothing to read: no profiled stretch, a program without
that tracer, or no record of that span, counter or kernel.
"""
from __future__ import annotations

import importlib

from . import ewa_work, program_trace

EWA_KERNEL = "ewa_kernel"        # csrc/ewa.cu, by the name the trace gives it


def tracer():
    """The program's tracer module, if it has named counters, else None."""
    try:
        tr = importlib.import_module("gyroflow_torch.trace")
    except ImportError:
        return None
    return tr if callable(getattr(tr, "counts", None)) else None


def span_ms(t, name: str):
    """ms a frame in the spans called `name`."""
    return None if tracer() is None else program_trace.span_ms(t, name)


def count_per_frame(t, name: str):
    """The named counter `name` a frame."""
    tr, d = tracer(), t.device
    if tr is None or not d or not d.frames:
        return None
    n = tr.counts().get(name)
    return None if n is None else n / d.frames


def ewa_roofline_pct(t):
    """100 x the frame's EWA sampling bound (``ewa_work``) over the device
    time a frame spends in the EWA kernel's launches."""
    if tracer() is None:
        return None
    d, size = t.device, ewa_work.frame_size(t.work)
    if not d or not d.frames or size is None:
        return None
    spent = d.seconds("kernel", lambda n: EWA_KERNEL in n) / d.frames
    if spent <= 0:
        return None
    return 100.0 * ewa_work.bound_s(*size) / spent
