"""The two kinds of traffic: a render (export) and an editor's preview.

One traffic file (``traffic/<name>.json``) names its kind and parameters;
``make_loop`` builds the loop from them. Both are closed loops with one
client: the next window (render) or frame (preview) starts when the last one
was issued (render) or shown (preview). Frame i has the clip's timestamp of
frame i (wrapping at the clip's end) and the pool's frame i mod the pool
size.

- ``render``: what ``render.renderer.render()`` does between its reader and
  its writer. A reader thread hands over decoded frames, warming each one's
  FrameTransform first (``decode_ahead``'s ``_warm_ft`` prefetch); the main
  loop stacks each plane group of a ``frame_window`` of frames with
  ``np.stack`` into a host buffer of its own that every window reuses (the
  upload has finished when ``process_pixels_window`` returns), passes it to
  ``process_pixels_window`` (``plane_rects``, the group's background), and
  downloads frames with ``.cpu().numpy()`` into a null sink whenever more
  than ``pipeline_depth`` are in flight. A frame counts when both its planes
  are on the host.
- ``preview``: one frame at a time through ``process_pixels``, Y then UV
  (``plane_rects``), each at a new timestamp, its FrameTransform called just
  before (so ``process_pixels`` finds it cached); the frame's time runs from
  before the FrameTransform to ``torch.cuda.synchronize()``, and its output
  stays on the card.

Each loop offers every finished frame to a seeded reservoir sample, kept for
the comparison with the reference after the window.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from .deploy import timestamp_us


class Sample:
    """k frames drawn uniformly from the stream of finished frames
    (reservoir sampling, seeded), whatever their number turns out to be."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed % (1 << 63), 1])
        self.seen = 0
        self.items = []

    def slot(self):
        """The slot the next finished frame goes into, or None."""
        n = self.seen
        self.seen += 1
        if n < self.k:
            self.items.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None


@dataclass
class Entry:
    index: int
    ts_us: int


class _Reader:
    """The decode-ahead thread: frame i's FrameTransform warmed, then the
    frame handed over through a bounded queue."""

    def __init__(self, dep, start: int, depth: int, spans):
        self._dep, self._spans = dep, spans
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._next = start
        self._t = threading.Thread(target=self._run, name="portbench-reader", daemon=True)
        self._t.start()

    def _run(self):
        mgr = self._dep.mgr
        try:
            while not self._stop.is_set():
                e = Entry(self._next, timestamp_us(self._dep.cfg, self._next))
                self._next += 1
                with self._spans.span("ft"):
                    mgr.frame_transform_at(mgr._adjusted_ts_ms(e.ts_us))
                self._put(e)
        except Exception as exc:  # noqa: BLE001 — re-raised on the main thread
            self._put(exc)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def get(self) -> Entry:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._t.join(timeout=30)
        if self._t.is_alive():
            raise RuntimeError("the reader thread did not stop")


class RenderLoop:
    def __init__(self, dep, traffic: dict, spans, sample: Sample):
        self.dep, self.spans, self.sample = dep, spans, sample
        self.window = traffic["frame_window"]
        self.depth = traffic["pipeline_depth"]
        self.interpolation = traffic["interpolation"]
        self.reader = _Reader(dep, 0, traffic["decode_ahead"], spans)
        self.stacked = {}           # plane -> the (window, H, W, C) host buffer
        self.inflight = []
        self.done = 0               # frames on the host

    def step(self):
        """One window: dispatch both plane groups, then download down to the
        pipeline depth."""
        dep, mgr = self.dep, self.dep.mgr
        entries = [self.reader.get() for _ in range(self.window)]
        ts = [e.ts_us for e in entries]
        outs = []
        for gi, plane in enumerate(("y", "uv")):
            with self.spans.span("stack"):
                planes = [getattr(dep.frame(e.index), plane) for e in entries]
                if plane not in self.stacked:
                    self.stacked[plane] = np.empty((len(planes),) + planes[0].shape,
                                                   planes[0].dtype)
                data = np.stack(planes, out=self.stacked[plane])
            with self.spans.span("dispatch"):
                out, _ = mgr.process_pixels_window(
                    ts, data, None, interpolation=self.interpolation, plane_index=gi,
                    max_pixel_value=dep.maxv, plane_rects=True,
                    background_override=dep.backgrounds[gi])
            outs.append(out)
        self.spans.frames += len(entries)
        for k, e in enumerate(entries):
            self.inflight.append((e, outs[0][k], outs[1][k]))
        while len(self.inflight) > self.depth:
            self._emit()

    def _emit(self):
        e, y, uv = self.inflight.pop(0)
        with self.spans.span("download"):
            planes = (y.cpu().numpy(), uv.cpu().numpy())
        self.done += 1
        slot = self.sample.slot()
        if slot is not None:
            self.sample.items[slot] = (e.index, e.ts_us, planes)

    def drain(self):
        while self.inflight:
            self._emit()

    def close(self):
        self.reader.close()


class PreviewLoop:
    def __init__(self, dep, traffic: dict, spans, sample: Sample):
        self.dep, self.spans, self.sample = dep, spans, sample
        self.interpolation = traffic["interpolation"]
        self.next = 0
        self.done = 0
        self.latencies = []

    def step(self):
        dep, mgr = self.dep, self.dep.mgr
        i = self.next
        self.next += 1
        ts = timestamp_us(dep.cfg, i)
        frame = dep.frame(i)
        t0 = time.perf_counter()
        with self.spans.span("ft"):
            mgr.frame_transform_at(mgr._adjusted_ts_ms(ts))
        with self.spans.span("dispatch"):
            oy, _ = mgr.process_pixels(ts, frame.y, interpolation=self.interpolation,
                                       plane_index=0, max_pixel_value=dep.maxv, plane_rects=True,
                                       background_override=dep.backgrounds[0])
            ouv, _ = mgr.process_pixels(ts, frame.uv, interpolation=self.interpolation,
                                        plane_index=1, max_pixel_value=dep.maxv, plane_rects=True,
                                        background_override=dep.backgrounds[1])
        dep.sync()
        self.latencies.append(time.perf_counter() - t0)
        self.spans.frames += 1
        self.done += 1
        slot = self.sample.slot()
        if slot is not None:
            self.sample.items[slot] = (i, ts, (oy.cpu().numpy(), ouv.cpu().numpy()))

    def drain(self):
        pass

    def close(self):
        pass


LOOPS = {"render": RenderLoop, "preview": PreviewLoop}


def make_loop(dep, traffic: dict, spans, sample: Sample):
    return LOOPS[traffic["kind"]](dep, traffic, spans, sample)
