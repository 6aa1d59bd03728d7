"""gyroflow_torch.trace, the port's tracer, on the CPU at small sizes.

- Off (no ``enable()``, no profiler) a span is one shared do-nothing object:
  ``process_pixels`` leaves no record and calls no ``record_function``.
- Under ``torch.profiler`` (CPU activity) a Y plus UV frame leaves
  ``gf.process_pixels`` twice, its children nested inside it on one thread,
  the frame's timestamp as request id on every span, self times of 0 or
  more, and each record matches a ``gf.*`` range of the exported Chrome
  trace by name and duration (within 20 us).
- A profiled stretch never reads the records of an earlier one.
- ``gf.host_syncs`` counts the sites a card blocks at: a fisheye frame's two
  plane uploads, its matrices once and each plane's dynamics (5); a Sony
  mesh frame adds its mesh buffer (6); an F-frame window its frames,
  matrices (and meshes) in one copy each plus each frame's dynamics.
- Named counters (``trace.count``) sit on the innermost open span, or in the
  total alone outside any; ``counts()`` sums the newest episode; off, they
  record nothing.
- The buffer is bounded while the episode's totals keep every span; spans
  on another thread have their own parents.
- ``render(trace=True)`` puts its stage timers on the tracer.
"""
import json
import threading

import numpy as np
import pytest
import torch

from gyroflow_torch import trace
from gyroflow_torch.core import lens_profile as tlp
from gyroflow_torch.core.manager import StabilizationManager

from test_end_to_end import H, W, gcsv_path  # noqa: F401 (fixture)
from test_torch_cli import clip  # noqa: F401 (fixture)
from test_torch_manager import _build
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MAXV = 1023.0


@pytest.fixture(scope="module")
def mgr(gcsv_path):  # noqa: F811
    return _build(StabilizationManager(device="cpu"), tlp, gcsv_path)


@pytest.fixture(scope="module")
def sony(tmp_path_factory):
    from chip_smoke import make_sony_manager
    return make_sony_manager(torch.device("cpu"), tmp_path_factory.mktemp("sony"), 160, 96, 8, 5)


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the tracer off and an empty episode."""
    trace.enable()
    trace.disable()
    yield
    trace.disable()


def _planes(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1024, (h, w, 1)).astype(np.uint16),
            rng.integers(0, 1024, (h // 2, w // 2, 2)).astype(np.uint16))


def _frame(m, ts_us, w, h):
    """One frame, Y then UV, as the preview gives it."""
    y, uv = _planes(w, h)
    for i, plane in enumerate((y, uv)):
        m.process_pixels(ts_us, plane, interpolation=8, plane_index=i, max_pixel_value=MAXV,
                         plane_rects=True)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_off_is_one_shared_object():
    assert trace.span("gf.a") is trace.span("gf.b", 5)
    with trace.span("gf.a") as sp:
        sp.note("x")
    assert trace.records() == [] and trace.totals() == {}


def test_off_leaves_no_record_and_calls_no_record_function(mgr, monkeypatch):
    calls = []

    class Counting:
        def __init__(self, name, *a):
            calls.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    _frame(mgr, 400_000, W, H)
    assert trace.records() == [] and trace.totals() == {} and trace.syncs() == 0
    assert calls == []


def test_profiled_frame_nests_under_process_pixels(mgr, tmp_path):
    ts = 433_333
    prof = _profiled(lambda: _frame(mgr, ts, W, H))
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.name == "gf.process_pixels"]
    assert len(roots) == 2 and all(r.parent is None for r in roots)
    names = {r.name for r in recs}
    assert {"gf.upload", "gf.eager", "gf.ft", "gf.ft.rows", "gf.ft.lens"} <= names
    assert [r.note for r in recs if r.name == "gf.ft"] == ["miss", "hit"]
    for r in recs:
        assert r.rid == ts, r
        assert r.self_ns >= 0 and r.end_ns >= r.start_ns
        p = r
        while p.parent is not None:
            parent = by_id[p.parent]
            assert parent.start_ns <= p.start_ns and p.end_ns <= parent.end_ns
            p = parent
        assert p.name == "gf.process_pixels"
    # self time: the span less its children
    for root in roots:
        kids = sum(r.end_ns - r.start_ns for r in recs if r.parent == root.id)
        assert root.self_ns == root.end_ns - root.start_ns - kids

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("gf.")]
    for name in names:
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.start_ns)
        theirs = sorted((e for e in events if e["name"] == name), key=lambda e: float(e["ts"]))
        assert len(mine) == len(theirs), name
        for r, e in zip(mine, theirs):
            assert abs((r.end_ns - r.start_ns) * 1e-3 - float(e["dur"])) <= 20.0, (name, r, e)


@pytest.mark.parametrize("between", ["reading", "unprofiled frame"])
def test_second_stretch_does_not_see_the_first(mgr, between):
    first_ts, second_ts = (466_667, 500_000) if between == "reading" else (533_333, 566_667)
    _profiled(lambda: _frame(mgr, first_ts, W, H))
    if between == "reading":
        first = trace.records()
        assert {r.rid for r in first} == {first_ts}
    else:
        _frame(mgr, first_ts, W, H)
    _profiled(lambda: _frame(mgr, second_ts, W, H))
    second = trace.records()
    assert second and {r.rid for r in second} == {second_ts}
    assert trace.totals()["gf.process_pixels"].count == 2
    assert trace.syncs() == 5


def test_host_syncs_of_a_fisheye_frame(mgr):
    trace.enable()
    _frame(mgr, 700_000, W, H)
    recs = trace.records()
    # two plane uploads, the matrices once, each plane's dynamics
    assert trace.syncs() == 5
    assert [r.syncs for r in recs if r.name == "gf.upload"] == [1, 1]
    assert sum(r.syncs for r in recs if r.name == "gf.process_pixels") == 3
    # the same frame again: the matrices are cached on the device
    trace.enable()
    _frame(mgr, 700_000, W, H)
    assert trace.syncs() == 4


def test_host_syncs_of_a_mesh_frame(sony):
    trace.enable()
    _frame(sony, 100_000, 160, 96)
    # and the frame's mesh buffer
    assert trace.syncs() == 6


@pytest.mark.parametrize("kind", ["fisheye", "mesh"])
def test_host_syncs_of_a_window(mgr, sony, kind):
    m, (w, h), ts = (mgr, (W, H), [600_000, 633_333]) if kind == "fisheye" else \
        (sony, (160, 96), [133_333, 166_667])
    frames = np.stack([_planes(w, h, i)[0] for i in range(len(ts))])
    trace.enable()
    m.process_pixels_window(ts, frames, None, interpolation=8, plane_index=0,
                            max_pixel_value=MAXV, plane_rects=True)
    recs = trace.records()
    # the frames, the matrices (and meshes) in one copy each, then each
    # frame's dynamics
    assert trace.syncs() == (2 if kind == "fisheye" else 3) + len(ts)
    window = [r for r in recs if r.name == "gf.process_pixels_window"]
    assert len(window) == 1 and window[0].rid == ts[0]
    # each frame's lookup carries that frame's timestamp
    assert [r.rid for r in recs if r.name == "gf.ft"] == ts
    assert [r.syncs for r in recs if r.name == "gf.upload"] == [1]
    assert sum(r.name == "gf.ft" for r in recs) == len(ts)


def test_buffer_is_bounded_and_totals_keep_every_span(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 8)
    trace.enable()
    for i in range(20):
        with trace.span("gf.a", i):
            trace.sync()
    assert len(trace.records()) == 8
    assert [r.rid for r in trace.records()] == list(range(12, 20))
    assert trace.totals()["gf.a"].count == 20 and trace.syncs() == 20


def test_named_counts_sit_on_the_innermost_span():
    trace.enable()
    trace.count("gf.n", 3)              # outside any span: in the total alone
    with trace.span("gf.outer", 1):
        trace.count("gf.n", 2)
        with trace.span("gf.inner"):
            trace.count("gf.n", 5)
            trace.count("gf.m", 1)
            trace.sync()
    with trace.span("gf.inner"):
        trace.count("gf.n", 7)
    recs = trace.records()
    assert [(r.name, r.counts) for r in recs] == [
        ("gf.inner", {"gf.n": 5, "gf.m": 1}), ("gf.outer", {"gf.n": 2}),
        ("gf.inner", {"gf.n": 7})]
    assert [r.syncs for r in recs] == [1, 0, 0]
    totals = trace.totals()
    assert totals["gf.inner"].counts == {"gf.n": 12, "gf.m": 1}
    assert totals["gf.outer"].counts == {"gf.n": 2}
    assert trace.counts() == {"gf.n": 17, "gf.m": 1} and trace.syncs() == 1
    # a new episode reads nothing of the last
    trace.enable()
    assert trace.counts() == {} and trace.totals() == {}
    with trace.span("gf.a"):
        pass
    assert trace.totals()["gf.a"].counts is None and trace.records()[0].counts is None


def test_counts_off_record_nothing():
    trace.count("gf.n", 4)
    with trace.span("gf.a"):
        trace.count("gf.n", 1)
    assert trace.counts() == {} and trace.totals() == {} and trace.records() == []


def test_counts_of_a_profiled_stretch():
    def counted():
        with trace.span("gf.a"):
            trace.count("gf.n", 2)
        trace.count("gf.n", 1)
    _profiled(counted)
    assert trace.counts() == {"gf.n": 3}
    _profiled(counted)
    assert trace.counts() == {"gf.n": 3}


def test_threads_keep_their_own_parents():
    trace.enable()
    seen = []

    def other():
        with trace.span("gf.other", 2):
            pass
        seen.append(True)

    with trace.span("gf.main", 1):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    recs = {r.name: r for r in trace.records()}
    assert seen and recs["gf.other"].parent is None and recs["gf.other"].rid == 2
    assert recs["gf.main"].self_ns == recs["gf.main"].end_ns - recs["gf.main"].start_ns


def test_render_trace_stats(clip, gcsv_path, tmp_path, capsys):  # noqa: F811
    from gyroflow_torch import cli
    from gyroflow_torch.render.renderer import RenderOptions, render
    from test_torch_render import make_mgr

    s = render(make_mgr(gcsv_path), clip, str(tmp_path / "out.y4m"),
               RenderOptions(frame_window=4, trace=True))
    assert not trace.TRACER.enabled and "stage_ms_per_frame" not in s
    st = s["trace"]
    assert set(st) == {"decode_s", "stabilize_s", "encode_s", "wall_s", "ms_per_frame",
                       "host_syncs_per_frame"}
    assert st["stabilize_s"] > 0 and st["wall_s"] >= st["stabilize_s"]
    assert {"gf.render.decode", "gf.render.stabilize", "gf.render.encode",
            "gf.process_pixels_window", "gf.upload", "gf.eager", "gf.ft"} <= set(st["ms_per_frame"])
    assert st["host_syncs_per_frame"] > 0
    trace.enable()
    trace.disable()
    off = render(make_mgr(gcsv_path), clip, str(tmp_path / "out2.y4m"),
                 RenderOptions(frame_window=4))
    assert "trace" not in off and trace.records() == []

    # an episode the caller records in stays on, keeps its records, and the
    # render's stats read only what the render added
    trace.enable()
    with trace.span("gf.caller", 7):
        trace.sync()
    s2 = render(make_mgr(gcsv_path), clip, str(tmp_path / "out3.y4m"),
                RenderOptions(frame_window=4, trace=True))
    assert trace.TRACER.enabled
    assert [r for r in trace.records() if r.name == "gf.caller"]
    assert "gf.caller" not in s2["trace"]["ms_per_frame"]
    assert s2["trace"]["host_syncs_per_frame"] == st["host_syncs_per_frame"]
    trace.disable()

    assert cli.main([clip, "-g", gcsv_path, "-f", "-t", "_tr", "--trace", "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("trace: ")]
    assert len(line) == 1 and "'stabilize_s'" in line[0] and "'gf.process_pixels" in line[0]
