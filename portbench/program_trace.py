"""What the program's own tracer (``gyroflow_torch.trace``) recorded over the
profiled stretch, a frame at a time, for the per-layer readers.

While ``torch.profiler`` runs, the program records its spans and its host-sync
counter in memory, one episode a profiled stretch; the readers run right after
the stretch, so the tracer's newest episode is that stretch. Each function
returns None where there is nothing to read: no profiled stretch (no card), a
program without the tracer, or no record of that span.
"""
from __future__ import annotations

import importlib


def _tracer():
    try:
        return importlib.import_module("gyroflow_torch.trace")
    except ImportError:
        return None


def _frames(t):
    d = t.device
    return d.frames if d is not None and d.frames else None


def span_ms(t, name: str, self_time: bool = False):
    """ms a frame in the spans called `name` (their self time: less what
    their child spans cover)."""
    tr, frames = _tracer(), _frames(t)
    if tr is None or frames is None:
        return None
    total = tr.totals().get(name)
    if total is None:
        return None
    return (total.self_seconds if self_time else total.seconds) * 1e3 / frames


def host_syncs(t):
    """Host syncs a frame the program counted (``gf.host_syncs``)."""
    tr, frames = _tracer(), _frames(t)
    if tr is None or frames is None or not tr.totals():
        return None
    return tr.syncs() / frames
