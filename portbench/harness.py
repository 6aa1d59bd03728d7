"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison with the reference, and the result line.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name: the cell and its metrics in
``BENCHMARK.json``, the configuration in the file it names, the traffic in
``traffic/<name>.json``, each per-layer metric's reader in
``metrics/<name>.py`` (a ``read(trace)`` that returns the number, or None
where it finds nothing to read). The run needs as many CUDA cards as the
cell asks for and never falls back to the CPU; ``run_cell`` itself runs on
any device, which is how the tests drive it on the CPU at a small size.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check, deploy, roofline, trace
from .loops import Sample, make_loop

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gyroflow_tpu")
MIB = float(1 << 20)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_traffic(name: str, pkg: Path = PKG) -> dict:
    return json.loads((pkg / "traffic" / f"{name}.json").read_text())


def load_reader(name: str, pkg: Path = PKG):
    """The read(trace) function of the per-layer metric `name`."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def catalog(pkg: Path = PKG) -> dict:
    """The configurations, traffic mixes and per-layer readers on disk."""
    def names(sub, suffix):
        return sorted(p.name[:-len(suffix)] for p in (pkg / sub).glob(f"*{suffix}"))
    return {"configs": names("configs", ".json"), "traffic": names("traffic", ".json"),
            "metrics": names("metrics", ".py")}


def cell_metrics(bench: dict, cell: str, section: str) -> list:
    """The metrics of `section` that the cell reports."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def process_start() -> float:
    """This process's start on the time.time() clock (Linux /proc)."""
    with open("/proc/self/stat") as fh:
        start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Deployment:
    """The program under test on one deployment: its manager, the frame pool,
    the planes' backgrounds and 10-bit limit."""
    cfg: dict
    mgr: object
    pool: list
    backgrounds: list
    maxv: float
    device: torch.device

    def frame(self, i: int):
        return self.pool[i % len(self.pool)]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(cfg: dict, traffic: dict, metrics: dict, seed: int, seconds: float,
             traced: bool, device, t_process: float, pkg: Path = PKG,
             control: bool = False) -> dict:
    """One run. metrics: {"end_to_end": [...], "per_layer": [...]}, the
    cell's entries of BENCHMARK.json. Returns the result object (without
    ``device``)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    spans = trace.Spans(on=False)
    phases = {}

    def phase(name):
        phases[name] = time.time() - t_process

    try:
        phase("start")
        telemetry = deploy.write_telemetry(workdir, cfg, seed)
        phase("telemetry_written")
        mgr = deploy.program_manager(cfg, telemetry, device)
        phase("manager_loaded")
        maxv = float((1 << cfg["bit_depth"]) - 1)
        from gyroflow_torch.ops.pixel_formats import rgb_to_yuv
        yuva = rgb_to_yuv(np.asarray(mgr.params.background, np.float32), True)
        dep = Deployment(cfg, mgr, deploy.frame_pool(cfg, seed, traffic["pool_frames"], device),
                         [yuva[..., :1], yuva[..., 1:3]], maxv, device)
        sample = Sample(traffic["check_frames"], seed)
        loop = make_loop(dep, traffic, spans, sample)
        phase("frames_made")
        try:
            for _ in range(traffic["warm_steps"]):
                loop.step()
            loop.drain()
            dep.sync()
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            sample.seen, sample.items = 0, []
            loop.done = 0
            if hasattr(loop, "latencies"):
                loop.latencies = []
            spans.on, spans.frames = traced, 0
            t0 = time.perf_counter()
            setup_s = time.time() - t_process
            while time.perf_counter() - t0 < seconds:
                loop.step()
            loop.drain()
            dep.sync()
            window_s = time.perf_counter() - t0
            spans.on = False
            frames, span_frames = loop.done, spans.frames
            window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
            device_trace = None
            if traced and on_card:
                spans.annotate = True
                steps = traffic["traced_steps"]
                per_step = traffic.get("frame_window", 1)

                def stretch():
                    for _ in range(steps):
                        loop.step()
                    loop.drain()
                device_trace = trace.profile_stretch(stretch, steps * per_step, dep.sync)
                spans.annotate = False
            latencies = list(getattr(loop, "latencies", []))
        finally:
            loop.close()
        pool = dep.pool
        del loop, mgr, dep
        if on_card:
            torch.cuda.empty_cache()

        res = {"correct": None, "attempted": frames, "failed": 0, "metrics": {}}
        e2e = {"render_fps": lambda: frames / window_s,
               "preview_ms_p95": lambda: percentile(latencies, 95) * 1e3,
               "device_peak_mib": lambda: window_peak / MIB,
               "setup_s": lambda: setup_s}
        log = {"frames": frames, "window_s": window_s, "setup_s": setup_s, "phases_s": phases}
        if latencies:
            log.update(preview_samples=len(latencies),
                       preview_ms_p50=statistics.median(latencies) * 1e3)
        if not traced:
            for m in metrics["end_to_end"]:
                res["metrics"][m["name"]] = {"value": e2e[m["name"]](), "unit": m["unit"]}
        else:
            data = trace.TraceData(spans=dict(spans.seconds), frames=span_frames,
                                   device=device_trace, work=roofline.frame_work(cfg))
            for m in metrics["per_layer"]:
                value = load_reader(m["name"], pkg)(data)
                if value is not None:
                    res["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
            if device_trace is not None:
                res["busy_s"] = device_trace.busy_s
                res["trace_window_s"] = device_trace.window_s
                res["breakdown"] = trace.breakdown(device_trace)
        print(json.dumps({"portbench_log": log}), file=sys.stderr)

        t_ref = time.perf_counter()
        verdict = check.compare(cfg, traffic, telemetry, pool, sample.items, device, control)
        print(json.dumps({"portbench_check": {"reference_s": time.perf_counter() - t_ref,
                                              "per_frame": verdict["per_frame"]}}),
              file=sys.stderr)
        res["correct"] = verdict["correct"]
        res["failed"] = verdict["failed"]
        res["memory_peak_bytes"] = window_peak
        res["check"] = verdict["numbers"]
        if control:
            res["control"] = verdict["control"]
            res["per_frame"] = verdict["per_frame"]
        return res
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def card_info() -> dict:
    """The card's name as torch gives it, its power limit as nvidia-smi reads
    it, and the number of cards."""
    limit = "not read"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        limit = out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"kind": torch.cuda.get_device_name(0), "power_limit": limit,
            "count": torch.cuda.device_count()}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--list", action="store_true", help="list the cells and the files found")
    args = ap.parse_args(argv)
    t_process = process_start()
    bench = load_benchmark()
    if args.list:
        print(json.dumps({"workloads": [w["name"] for w in bench["workloads"]], **catalog()}))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), "
              f"{n_cards} visible; nothing measured", file=sys.stderr)
        return 2
    card = card_info()
    print(f"portbench: {card['kind']}, power limit {card['power_limit']}, "
          f"{card['count']} card(s)", file=sys.stderr)
    cfg = deploy.load_config(cell["config"], bench)
    traffic = load_traffic(cell["traffic"])
    metrics = {s: cell_metrics(bench, cell["name"], s) for s in ("end_to_end", "per_layer")}
    res = run_cell(cfg, traffic, metrics, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window; no result", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": card["kind"], "count": cell["chips"],
              "memory_peak_bytes": int(res.pop("memory_peak_bytes")),
              "power_limit": card["power_limit"]}
    if "busy_s" in res:
        device["busy_s"] = res.pop("busy_s")
        device["window_s"] = res.pop("trace_window_s")
    numbers = res.pop("check")
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["check"] = numbers
    for name, n in numbers.items():
        print(f"check {name}: {n['value']} (limit {n['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
