"""The benchmark's tests: on the CPU at small sizes, and on a card where one
is present (marked ``cuda``; the card is looked for inside a fixture)."""
import copy

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def all_cells() -> dict:
    """BENCHMARK.json's cells and metrics, with those of ``later_cells.json``
    (the render cells) added."""
    import json

    from portbench import harness

    bench = harness.load_benchmark()
    later = json.loads((harness.PKG / "later_cells.json").read_text())
    return {s: bench[s] + later.get(s, []) for s in ("workloads", "end_to_end", "per_layer")} | {
        "configs": bench["configs"]}


@pytest.fixture
def small():
    """small(cell) -> (cell, cfg, traffic, metrics) of a cell of BENCHMARK.json
    or ``later_cells.json`` with its clip cut to 160x96 and 2 s, for runs on
    the CPU."""
    from portbench import deploy, harness

    bench = all_cells()

    def make(name, width=160, height=96, clip_seconds=2):
        cell = {w["name"]: w for w in bench["workloads"]}[name]
        cfg = copy.deepcopy(deploy.load_config(cell["config"], bench))
        cfg.update(width=width, height=height, clip_seconds=clip_seconds)
        traffic = harness.load_traffic(cell["traffic"])
        metrics = {s: harness.cell_metrics(bench, name, s) for s in ("end_to_end", "per_layer")}
        return cell, cfg, traffic, metrics
    return make
