"""The port's tracer: spans and counters inside the program, kept in memory.

A span (``with trace.span(name, rid):``) records its name, its start and end
(``time.perf_counter_ns``), the span open around it on the same thread (its
parent), its self time (its length less what its children on that thread
cover) and a request id. A span's request id is the one it is given (the
frame's video timestamp in us, so the Y and UV calls of one frame share it,
and each frame's FrameTransform lookup in a window has its own); a span given
none takes its parent's. The counter ``gf.host_syncs`` (``trace.sync()``,
read by ``syncs()``) counts the program's calls that block the host on the
stream (every upload through ``to_device``), at the call site and on any
device, so a CPU run counts what a card would. Named counters
(``trace.count(name, n)``, read by ``counts()``) add n to the counter
``name`` the same way: ``gf.coords.points`` counts the
positions each coords-kernel launch projects (``ops/cuda_coords.py``), at the
call, so the plain version on the CPU counts what the kernel would, and
``gf.coords.gen_ewa_planes`` the EWA planes whose stacked evals take the
self-contained coords kernel. A count
of either kind is recorded on the innermost open span of its thread, in that
span's record (``syncs``, ``counts``), so it sits at the boundary where the
work happens; a count outside any span is kept in the total alone.

Recording is on only while ``enable()`` holds (``render(..., trace=True)``,
``cli --trace``) or a ``torch.profiler`` session runs. While a profiler runs,
each span is also a profiler range of its name (``record_function``'s kind,
opened by ``_RecordFunctionFast``), so the profiler's trace shows it on the
same clock as the card's kernels and copies. Off, a span costs two boolean
tests and returns one shared do-nothing context: no allocation, no
formatting, nothing on the card; ``sync()`` and ``count()`` cost the same
two boolean tests.

Records go into a bounded buffer (the newest ``MAX_RECORDS``) and belong to an
episode: ``enable()`` starts one, and so does the first span that finds a
profiler running after the tracer last saw none (it looks at every span and
counter call and at every reading). ``records()`` gives the newest episode's
records, ``totals()``, ``syncs()`` and ``counts()`` its sums over the whole
episode, kept even where the buffer dropped its oldest records. Nothing of an
earlier episode is read in a later one: a span still open when a new episode
starts is dropped at its end.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

MAX_RECORDS = 1 << 16
_profiling = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]    # the id of the span open around it on its thread
    rid: Optional[int]       # request id: the frame's timestamp in us
    self_ns: int
    syncs: int               # host syncs counted while it was the innermost span
    note: object             # e.g. "hit" / "miss" of a FrameTransform lookup
    counts: Optional[Dict[str, int]] = None   # named counts while it was the innermost span


class Total(NamedTuple):
    """One span name's sums over an episode."""
    count: int
    seconds: float
    self_seconds: float
    syncs: int
    counts: Optional[Dict[str, int]] = None   # named counts inside spans of this name


class _Off:
    """The span while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, value):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("tr", "name", "rid", "episode", "id", "parent", "child_ns", "syncs", "counts",
                 "value", "rf", "t0")

    def __init__(self, tr: "Tracer", name: str, rid):
        self.tr, self.name, self.rid = tr, name, rid

    def note(self, value):
        self.value = value

    def __enter__(self):
        tr = self.tr
        profiling = tr._see_profiler()
        stack = tr._stack()
        self.episode = tr._episode
        self.id = next(tr._ids)
        self.parent = None
        if stack:
            self.parent = stack[-1].id
            if self.rid is None:
                self.rid = stack[-1].rid
        self.child_ns = self.syncs = 0
        self.counts = self.value = None
        self.rf = None
        stack.append(self)
        if profiling:
            # record_function's kind of range, opened without its round trip
            # through the dispatcher: a tenth of its cost, and a range that
            # starts and ends where the span's record does
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        # the profiler's range starts as its enter call returns and ends as
        # its exit call returns: the record's times are taken there
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        t1 = time.perf_counter_ns()
        tr = self.tr
        stack = tr._stack()
        stack.pop()
        dur = t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        tr._add(self.episode, Record(self.name, self.t0, t1, self.id, self.parent, self.rid,
                                     dur - self.child_ns, self.syncs, self.value, self.counts))
        return False


class Tracer:
    def __init__(self):
        self.enabled = False
        self._prof_seen = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._episode = 0
        self._records: deque = deque(maxlen=MAX_RECORDS)
        self._totals: Dict[str, list] = {}
        self._loose_syncs = 0
        self._loose_counts: Dict[str, int] = {}

    # ---- the switch ---------------------------------------------------------

    def enable(self):
        """Record from now on, in a new episode, until ``disable()``."""
        with self._lock:
            self._new_episode()
        self.enabled = True

    def disable(self):
        """Stop recording (a running profiler still records); the episode
        stays readable until the next one starts."""
        self.enabled = False

    # ---- recording ----------------------------------------------------------

    def span(self, name: str, rid: Optional[int] = None):
        """A context manager timing ``name``; ``rid`` is its request id (None:
        its parent's). ``.note(value)`` on it sets
        the record's note."""
        if self.enabled or _profiling():
            return _Span(self, name, rid)
        self._prof_seen = False
        return _OFF

    def sync(self):
        """Count one call that blocks the host on the stream."""
        if not self.enabled and not _profiling():
            self._prof_seen = False
            return
        self._see_profiler()
        stack = self._stack()
        if stack and stack[-1].episode == self._episode:
            stack[-1].syncs += 1
        else:
            with self._lock:
                self._loose_syncs += 1

    def count(self, name: str, n: int):
        """Add n to the named counter ``name`` (e.g. ``gf.coords.points``)."""
        if not self.enabled and not _profiling():
            self._prof_seen = False
            return
        self._see_profiler()
        stack = self._stack()
        if stack and stack[-1].episode == self._episode:
            top = stack[-1]
            if top.counts is None:
                top.counts = {}
            top.counts[name] = top.counts.get(name, 0) + n
        else:
            with self._lock:
                self._loose_counts[name] = self._loose_counts.get(name, 0) + n

    # ---- reading ------------------------------------------------------------

    def records(self) -> List[Record]:
        """The newest episode's records (its newest MAX_RECORDS), in the order
        the spans ended."""
        self._look()
        return list(self._records)

    def totals(self) -> Dict[str, Total]:
        """Per span name, the newest episode's count, seconds, self seconds,
        host syncs and named counts (None where its spans counted none)."""
        self._look()
        with self._lock:
            return {k: Total(n, ns * 1e-9, self_ns * 1e-9, s, dict(c) or None)
                    for k, (n, ns, self_ns, s, c) in self._totals.items()}

    def syncs(self) -> int:
        """The newest episode's host syncs, inside spans and outside."""
        self._look()
        with self._lock:
            return self._loose_syncs + sum(t[3] for t in self._totals.values())

    def counts(self) -> Dict[str, int]:
        """The newest episode's named counters, inside spans and outside."""
        self._look()
        with self._lock:
            out = dict(self._loose_counts)
            for t in self._totals.values():
                for name, n in t[4].items():
                    out[name] = out.get(name, 0) + n
            return out

    # ---- internals ----------------------------------------------------------

    def _look(self):
        if not _profiling():
            self._prof_seen = False

    def _see_profiler(self) -> bool:
        on = _profiling()
        if not on:
            self._prof_seen = False
        elif not self._prof_seen:
            with self._lock:
                if not self._prof_seen:
                    self._new_episode()
                    self._prof_seen = True
        return on

    def _new_episode(self):
        self._episode += 1
        self._records = deque(maxlen=MAX_RECORDS)
        self._totals = {}
        self._loose_syncs = 0
        self._loose_counts = {}

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, episode: int, rec: Record):
        with self._lock:
            if episode != self._episode:
                return
            self._records.append(rec)
            t = self._totals.get(rec.name)
            if t is None:
                t = self._totals[rec.name] = [0, 0, 0, 0, {}]
            t[0] += 1
            t[1] += rec.end_ns - rec.start_ns
            t[2] += rec.self_ns
            t[3] += rec.syncs
            for name, n in (rec.counts or {}).items():
                t[4][name] = t[4].get(name, 0) + n


def from_host(data, device) -> bool:
    """Whether putting data on device copies it from the host, the copy that
    blocks the host on the stream: data is not a tensor on that card already.
    Host data counts on the CPU too, so a CPU run counts what a card would."""
    return not (isinstance(data, torch.Tensor) and data.device.type != "cpu"
                and data.device == torch.device(device))


def to_device(t: torch.Tensor, device, **kw) -> torch.Tensor:
    """``t.to(device, **kw)``, one ``gf.host_syncs`` counted first where t
    comes from the host (``from_host``): every upload of the program."""
    if from_host(t, device):
        sync()
    return t.to(device, **kw)


TRACER = Tracer()
enable = TRACER.enable
disable = TRACER.disable
span = TRACER.span
sync = TRACER.sync
count = TRACER.count
records = TRACER.records
totals = TRACER.totals
syncs = TRACER.syncs
counts = TRACER.counts
