"""The harness on the CPU at a small size: data found by name, each cell's
run correct, the measurement command refusing to run with no card, and a
run driven with the timed path broken underneath coming out not correct."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import all_cells

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["gopro4k-preview", "sony4k-preview"]
LATER = ["gopro4k-render", "sony4k-render"]     # later_cells.json


def run(small, name, seconds=0.5, traced=False, seed=2 ** 31 + 5):
    cell, cfg, traffic, metrics = small(name)
    return harness.run_cell(cfg, traffic, metrics, seed, seconds, traced, "cpu",
                            harness.process_start())


def test_new_files_are_found_by_name(tmp_path):
    pkg = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.PKG / sub, pkg / sub)
    before = harness.catalog(pkg)
    (pkg / "configs" / "new-deployment.json").write_text("{}")
    (pkg / "traffic" / "new-mix.json").write_text(json.dumps({"kind": "render"}))
    (pkg / "metrics" / "new_metric.render.py").write_text("def read(t):\n    return 42.0\n")
    after = harness.catalog(pkg)
    assert set(after["configs"]) - set(before["configs"]) == {"new-deployment"}
    assert set(after["traffic"]) - set(before["traffic"]) == {"new-mix"}
    assert set(after["metrics"]) - set(before["metrics"]) == {"new_metric.render"}
    assert harness.load_traffic("new-mix", pkg) == {"kind": "render"}
    assert harness.load_reader("new_metric.render", pkg)(None) == 42.0


def test_every_metric_has_a_reader():
    bench = all_cells()
    names = set(harness.catalog()["metrics"])
    assert {m["name"] for m in bench["per_layer"]} == names
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_later_cells_are_not_in_the_benchmark():
    bench = harness.load_benchmark()
    later = json.loads((harness.PKG / "later_cells.json").read_text())
    assert [w["name"] for w in later["workloads"]] == LATER
    for section in ("workloads", "end_to_end", "per_layer"):
        names = {m["name"] for m in bench[section]}
        assert names.isdisjoint(m["name"] for m in later[section])
        cells = {w["name"] for w in bench["workloads"]}
        for m in bench[section]:
            assert cells.issuperset(m.get("workloads", cells))


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload", "gopro4k-preview",
                        "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_list():
    p = subprocess.run([sys.executable, "-m", "portbench", "--list"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    listed = json.loads(p.stdout.strip().splitlines()[-1])
    assert listed["workloads"] == CELLS
    assert listed["traffic"] == ["preview-closed1", "render-window8"]


@pytest.mark.parametrize("name", CELLS + LATER)
def test_cell_runs_correct(small, name):
    res = run(small, name)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    bench = all_cells()
    assert set(res["metrics"]) == {m["name"] for m in harness.cell_metrics(
        bench, name, "end_to_end")}
    assert all(v["value"] > 0 for k, v in res["metrics"].items() if k != "device_peak_mib")
    assert set(res["check"]) == {"max_code_diff", "mismatch_ppm"}


def test_traced_run_reads_host_spans(small):
    res = run(small, "gopro4k-render", traced=True)
    assert res["correct"] is True
    # no card: the device metrics find nothing to read and are left out
    assert set(res["metrics"]) == {"ft_ms.render", "dispatch_ms.render", "download_ms.render"}


def _altered_cast(orig):
    def cast(out, out_dtype, maxv):
        # each plane's rows one off, as an off-by-one in the output row would
        return orig(out.roll(1, dims=0), out_dtype, maxv)
    return cast


@pytest.mark.parametrize("name", ["gopro4k-render", "gopro4k-preview"])
def test_answer_altered_where_produced(small, monkeypatch, name):
    from gyroflow_torch.ops import remap
    monkeypatch.setattr(remap, "_cast_out", _altered_cast(remap._cast_out))
    res = run(small, name)
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("name", ["gopro4k-render", "sony4k-preview"])
def test_finish_floors_instead_of_rounding(small, monkeypatch, name):
    from gyroflow_torch.ops import remap
    orig = remap._cast_out

    def floored(out, out_dtype, maxv):
        return orig(torch.floor(out), out_dtype, maxv)
    monkeypatch.setattr(remap, "_cast_out", floored)
    res = run(small, name)
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("name", ["gopro4k-render", "gopro4k-preview"])
def test_uv_plane_sampled_bilinear(small, monkeypatch, name):
    """A fault in one plane alone: UV through bilinear, Y through lanczos4."""
    from gyroflow_torch.core.manager import StabilizationManager
    for entry in ("process_pixels", "process_pixels_window"):
        orig = getattr(StabilizationManager, entry)

        def uv_bilinear(self, *a, _orig=orig, **kw):
            if kw.get("plane_index") == 1:
                kw["interpolation"] = 2
            return _orig(self, *a, **kw)
        monkeypatch.setattr(StabilizationManager, entry, uv_bilinear)
    res = run(small, name)
    assert res["correct"] is False and res["failed"] > 0
    assert res["check"]["mismatch_ppm"]["value"] > res["check"]["mismatch_ppm"]["limit"]


def test_half_of_the_window_left_out(small, monkeypatch):
    from gyroflow_torch.core.manager import StabilizationManager
    orig = StabilizationManager.process_pixels_window

    def half(self, timestamps_us, frames, *a, **kw):
        n = len(timestamps_us) // 2
        out, info = orig(self, timestamps_us[:n], frames[:n], *a, **kw)
        return torch.cat([out, out]), info     # the second half repeats the first
    monkeypatch.setattr(StabilizationManager, "process_pixels_window", half)
    res = run(small, "gopro4k-render")
    assert res["correct"] is False and res["failed"] > 0


def test_stale_frame_transform(small, monkeypatch):
    from gyroflow_torch.core.manager import StabilizationManager
    orig = StabilizationManager.frame_transform_at
    first = {}

    def stale(self, ts_ms, frame=None):
        if "ft" not in first:
            first["ft"] = orig(self, ts_ms, frame)
        return first["ft"]
    monkeypatch.setattr(StabilizationManager, "frame_transform_at", stale)
    res = run(small, "gopro4k-render")
    assert res["correct"] is False and res["failed"] > 0


def test_control_fails_where_the_program_passes(small):
    cell, cfg, traffic, metrics = small("gopro4k-render")
    res = harness.run_cell(cfg, traffic, metrics, 2 ** 31 + 21, 0.5, False, "cpu",
                           harness.process_start(), control=True)
    assert res["correct"] is True
    assert res["control"]["correct"] is False
    assert res["control"]["failed"] == res["control"]["frames"] > 0


@pytest.mark.cuda
def test_control_on_the_card(card, small):
    """The control on the card at a small size, on three seeds: the program
    passes, the control fails every frame."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        cell, cfg, traffic, metrics = small("gopro4k-render", width=640, height=360)
        res = harness.run_cell(cfg, traffic, metrics, seed, 1.0, False, card,
                               harness.process_start(), control=True)
        assert res["correct"] is True
        assert res["control"]["failed"] == res["control"]["frames"] > 0
