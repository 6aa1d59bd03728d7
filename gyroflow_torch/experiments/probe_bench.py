"""Time the experiments' sampler-probe kernel (csrc/probe_sampler.cu),
per-tile-bbox fused kernel (csrc/fused_bbox.cu) and window-column-sum kernel
(csrc/probe_window.cu) of one or more copies of gyroflow_torch at
chip_smoke.py phase 7's shapes, on one CUDA card.

    python -m gyroflow_torch.experiments.probe_bench [ROOT ...]

Each ROOT is a directory holding a gyroflow_torch package (default: this
checkout), for example an unpacked ``git archive`` of another commit or an
edited copy of it. The inputs are made once, by this checkout, as phase 7
makes them: probe 4's Y plane (tile 16x128, window 48x256), probe 5's Y and
UV planes and probe 6's Y plane (tile 16x96, window 48 or 40 x 256, K 128),
float32 4K planes with their tiled u/v and window origins, and
``fused_bbox``'s Y and UV planes with coords_pre's x, y, idx and the matrix
table, and probe 3's plane and the origins of its four (align, Sc) cases
(``perf_probe3.inputs``) and of three more window cases that show its fixed
cost and the cost of its overlapping reads; with each sampler case the share
of pixels whose stencil takes the new kernels' fast path
(``probe_sampler.fast_share``, ``fused_bbox.fast_share``), and the timer's
floor (``perf_probe.cuda_ms`` of an add to 8 floats).
Every ROOT's kernel library is built first, three builds at a time. Then each
ROOT runs in a process of its own, in the order given and again in reverse
(A B ... B A), and reads for every case (``CASES``: probe 4 in the modes
noop, nobuild, nomatmul and full; probe 5 Y and UV; probe 6 in bf16, bf16x3
and fp32; fused_bbox Y and UV; the window at align 128, 32, 32, 8 and Sc 256,
256, 160, 160, then one tile, 512 tiles at one origin and 512 side by side,
with the design each copy's ``perf_probe3.window_path`` names, where it has
one):

- the kernel's device time with that copy's ``experiments.perf_probe.cuda_ms``
  (median of 10 calls, each behind an L2-flushing read and a device spin);
- the largest difference from that copy's plain version on the same inputs
  (nobuild: relative to the plain output's largest value, as phase 7 reads
  it; fused_bbox: over output, valid and bbox; the window must equal it);

and the ptxas registers and spills of the three kernels' instantiations, and of
the uint16 forms of sampler.cu and fused.cu, which share taps.cuh. Prints the
card's name and power limit, one JSON line per reading and a summary; writes
the summary to probe_bench.json in chip_smoke.py's output directory
(``chip_smoke.OUT_DIR``). Exits non-zero if a build, a launch or a check
fails (a difference above phase 7's limits). Not one of
``experiments.PROBES``: it compares designs of two kernels, it does not
measure the card.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TOL = 0.01                  # codes: phase 7's SAMPLER_TOL
NOBUILD_REL = 1e-4          # nobuild: relative to the plain output's largest value
BBOX_TOL = 1e-4             # px
BUILDS_AT_ONCE = 3
# (case, probe input, mode, precision); fused_bbox cases have no mode
CASES = (("probe4 noop", "p4", "noop", "fp32"), ("probe4 nobuild", "p4", "nobuild", "fp32"),
         ("probe4 nomatmul", "p4", "nomatmul", "fp32"), ("probe4 full", "p4", "full", "fp32"),
         ("probe5 Y", "p5 Y", "full", "fp32"), ("probe5 UV", "p5 UV", "full", "fp32"),
         ("probe6 bf16", "p6", "full", "bf16"), ("probe6 bf16x3", "p6", "full", "bf16x3"),
         ("probe6 fp32", "p6", "full", "fp32"),
         ("fused_bbox Y", "fb Y", None, None), ("fused_bbox UV", "fb UV", None, None),
         *((f"window align{a} Sc{sc}", f"p3 {a} {sc}", "window", None)
           for a, sc in ((128, 256), (32, 256), (32, 160), (8, 160))),
         # the window kernel's fixed cost and what its overlapping reads cost:
         # one tile; 512 tiles at one origin (their union one window); 512
         # tiles side by side (union = window bytes, 25.2 MB)
         ("window 1 tile Sc256", "p3 1 tile", "window", None),
         ("window same origin x512 Sc256", "p3 same", "window", None),
         ("window disjoint x512 Sc256", "p3 disjoint", "window", None))
# sums read in the summary, each a list of cases
SUMS = {"probe5 Y+UV": ("probe5 Y", "probe5 UV"),
        "fused_bbox Y+UV": ("fused_bbox Y", "fused_bbox UV"),
        "window": tuple(c[0] for c in CASES if c[0].startswith("window align"))}
# the kernels whose registers the summary keeps: mangled-name pieces
PTXAS_KERNELS = ("probe_sampler_kernel", "probe_tile_kernel", "fused_bbox_kernel",
                 "window_colsum_kernel", "window_colsum_tma_kernel",
                 "sampler_kernelItLi1ELi8E", "sampler_kernelItLi2ELi8E",
                 "fused_kernelItLi1ELi8ELb0EE", "fused_kernelItLi2ELi8ELb0EE")


def ptxas_report(log: str, pieces=PTXAS_KERNELS) -> dict:
    """{kernel: {"registers": N, "spill": [stores, loads]}} from an ``nvcc
    -Xptxas -v`` log, for the entry functions whose mangled name holds one
    of ``pieces``. The key is the mangled name from the piece up to its void
    return type (the kernel's name and template arguments)."""
    out, current = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            hit = next((p for p in pieces if p in name), None)
            tail = name[name.index(hit):] if hit else ""
            current = (tail[:tail.index("Ev")] if "Ev" in tail else hit) if hit else None
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if spill:
            out.setdefault(current, {})["spill"] = [int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", ln)
        if regs:
            out.setdefault(current, {})["registers"] = int(regs.group(1))
    return out


def order(roots):
    """A B ... B A: each root in the order given, then in reverse."""
    return list(roots) + list(roots)[::-1]


def summarise(readings: dict) -> dict:
    """Per root, from its readings ({root: [reading, ...]}, each reading
    {case: {"ms": t, "err": e}}, a window case also {"path": design}): each
    case's times in run order and their mean, the SUMS of the means, each
    case's largest difference and its design."""
    out = {}
    for root, runs in readings.items():
        cases = {}
        for case in runs[0]:
            ms = [r[case]["ms"] for r in runs]
            cases[case] = {"ms": ms, "mean_ms": statistics.mean(ms),
                           "max_err": max(r[case]["err"] for r in runs),
                           **{k: runs[0][case][k] for k in ("path",) if k in runs[0][case]}}
        sums = {k: sum(cases[c]["mean_ms"] for c in parts) for k, parts in SUMS.items()
                if all(c in cases for c in parts)}
        out[root] = {"cases": cases, "sums": sums}
    return out


def _inputs(path):
    """Phase 7's inputs for every case, on the host, saved to path, and each
    case's fast-path share."""
    import torch

    sys.path.insert(0, str(REPO))
    from gyroflow_torch.experiments import fused_bbox as fb
    from gyroflow_torch.experiments import perf_probe
    from gyroflow_torch.experiments import perf_probe3 as p3
    from gyroflow_torch.experiments import perf_probe4 as p4
    from gyroflow_torch.experiments import perf_probe5 as p5
    from gyroflow_torch.experiments import perf_probe6 as p6
    from gyroflow_torch.experiments import probe_sampler as ps
    from gyroflow_torch.ops import cuda_coords, remap

    dev = torch.device("cuda", 0)
    out, share = {}, {}
    img, u, v, _, y0, x0, xoff, _, _ = p4.inputs(dev)
    out["p4"] = (img, u, v, y0, x0, xoff, p4.WINDOW)
    for name, (img, u, v, _, y0, x0, xoff, _, _, window) in p5.inputs(dev).items():
        out[f"p5 {name}"] = (img, u, v, y0, x0, xoff, window)
    img, _, _, _, (u, v, _, y0, x0, xoff, _) = p6.inputs(dev)
    out["p6"] = (img, u, v, y0, x0, xoff, p6.WINDOW)
    for key, (img, u, v, y0, x0, xoff, window) in out.items():
        share[key] = ps.fast_share(img.shape, u, v, y0, x0, xoff, window)
    for name, (img, x, y, idx, mats, cfg, dyn, bg) in fb.inputs(dev).items():
        out[f"fb {name}"] = (img, x, y, idx, mats, cfg, dyn, bg)
        u, v, _ = cuda_coords.project(x, y, idx, mats, cfg, dyn)
        u, v = remap.coords_post_uv(u, v, cfg)
        share[f"fb {name}"] = fb.fast_share(remap._guard_uv(u), remap._guard_uv(v), cfg,
                                            img.shape)
    img, cases = p3.inputs(dev)
    for align, sc, y0, x0 in cases:
        out[f"p3 {align} {sc}"] = (img, y0, x0, sc)
    _, _, y0, x0 = cases[0]
    i = torch.arange(y0.shape[0], dtype=torch.int32, device=dev)
    out["p3 1 tile"] = (img, y0[:1], x0[:1], 256)
    out["p3 same"] = (img, i * 0 + 1000, i * 0 + 1024, 256)
    out["p3 disjoint"] = (img, (i // 15) * p3.SR, (i % 15) * 256, 256)
    host = {k: tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in t)
            for k, t in out.items()}
    torch.save(host, path)
    # the timer's floor: an add to 8 floats, read as every case is
    small = torch.zeros(8, device=dev)
    floor = perf_probe.cuda_ms(lambda: small.add_(1), dev)
    print(json.dumps({"inputs": path, "fast_share": share, "timer_floor_ms": floor}))


def _build(root):
    """Build ROOT's kernel library (run in a process of its own); ptxas
    reports only when this process built it."""
    sys.path.insert(0, str(root))
    from gyroflow_torch import _build as b
    t0 = time.perf_counter()
    b.build(verbose=True)
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": ptxas_report(b.build_log)}))


def _time(root, path):
    """Time and check ROOT's three kernels on the saved inputs (a process of
    its own)."""
    import torch

    sys.path.insert(0, str(root))
    import gyroflow_torch
    from gyroflow_torch.experiments import fused_bbox as fb
    from gyroflow_torch.experiments import perf_probe
    from gyroflow_torch.experiments import perf_probe3 as p3
    from gyroflow_torch.experiments import probe_sampler as ps

    if Path(gyroflow_torch.__file__).resolve().parent != (Path(root) / "gyroflow_torch").resolve():
        raise RuntimeError(f"imported {gyroflow_torch.__file__}, not the copy in {root}")
    dev = torch.device("cuda", 0)
    inputs = {k: tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in t)
              for k, t in torch.load(path, weights_only=False).items()}
    res = {}
    for case, key, mode, precision in CASES:
        args = inputs[key]
        design = None
        if mode == "window":
            img, y0, x0, sc = args
            k = p3.window_colsum(img, y0, x0, p3.SR, sc)
            p = p3.window_colsum_plain(img, y0, x0, p3.SR, sc)
            err = float((k - p).abs().max())
            ok = torch.equal(k, p)
            ms = perf_probe.cuda_ms(lambda: p3.window_colsum(img, y0, x0, p3.SR, sc), dev)
            if hasattr(p3, "window_path"):
                design = p3.window_path(img, p3.SR, sc)
        elif mode is None:
            k = fb.fused_bbox(*args)
            p = fb.fused_bbox_plain(*args)
            err = max(float((a - b).abs().max()) for a, b in zip(k, p))
            ok = (float((k[0] - p[0]).abs().max()) <= TOL and torch.equal(k[1], p[1])
                  and float((k[2] - p[2]).abs().max()) <= BBOX_TOL)
            ms = perf_probe.cuda_ms(lambda: fb.fused_bbox(*args), dev)
        else:
            k = ps.sample(*args, mode, precision)
            p = ps.sample_plain(*args, mode, precision)
            err = float((k - p).abs().max())
            ok = err <= (NOBUILD_REL * float(p.abs().max()) if mode == "nobuild" else TOL)
            ms = perf_probe.cuda_ms(lambda: ps.sample(*args, mode, precision), dev)
        torch.cuda.synchronize()
        if not (ok and bool(torch.isfinite(k[0] if mode is None else k).all())):
            raise AssertionError(f"{root} {case}: kernel off its plain version by {err}")
        res[case] = {"ms": ms, "err": err, **({"path": design} if design else {})}
    print(json.dumps(res))


def _run(args):
    res = subprocess.run([sys.executable, __file__, *args], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"probe_bench {' '.join(args)} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(roots) -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    roots = [str(Path(r).resolve()) for r in roots] or [str(REPO)]
    # BUILDS_AT_ONCE libraries at a time (each runs one nvcc per source)
    builds, failed, pending, running = {}, [], list(dict.fromkeys(roots)), []
    while pending or running:
        while pending and len(running) < BUILDS_AT_ONCE:
            r = pending.pop(0)
            running.append((r, subprocess.Popen([sys.executable, __file__, "--build", r],
                                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True)))
        r, p = running.pop(0)
        out, err = p.communicate()
        if p.returncode != 0:
            failed.append(r)
            print(f"build of {r} failed:\n{err[-6000:]}", flush=True)
            continue
        builds[r] = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"root": r, **builds[r]}), flush=True)
    if failed:
        raise RuntimeError(f"builds failed: {failed}")
    readings = {r: [] for r in roots}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "inputs.pt")
        got = _run(["--inputs", path])
        share, floor = got["fast_share"], got["timer_floor_ms"]
        print(json.dumps({"fast_share": share, "timer_floor_ms": floor}), flush=True)
        for r in order(roots):
            readings[r].append(_run(["--time", r, path]))
            print(json.dumps({"root": r, **readings[r][-1]}), flush=True)
    summary = {"card": smi, "fast_share": share, "timer_floor_ms": floor,
               "roots": [{"root": r, "ptxas": builds[r]["ptxas"], **s}
                         for r, s in summarise(readings).items()]}
    sys.path.insert(0, str(REPO))
    from chip_smoke import OUT_DIR
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "probe_bench.json").write_text(json.dumps(summary, indent=1))
    print(smi)
    print(json.dumps({"card": smi, "roots": [
        {"root": x["root"], **{c: round(v["mean_ms"], 4) for c, v in x["cases"].items()},
         **{k: round(v, 4) for k, v in x["sums"].items()}} for x in summary["roots"]]}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        _build(sys.argv[2])
    elif sys.argv[1:2] == ["--inputs"]:
        _inputs(sys.argv[2])
    elif sys.argv[1:2] == ["--time"]:
        _time(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main(sys.argv[1:]))
