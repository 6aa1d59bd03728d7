"""Time the EWA kernel (csrc/ewa.cu) of one or more copies of gyroflow_torch
on the 4K EWA inputs of chip_smoke.py, on one CUDA card.

    python -m gyroflow_torch.experiments.ewa_bench [ROOT ...]

Run from a checkout (it takes its inputs from the checkout's chip_smoke.py).
Each ROOT is a directory holding a gyroflow_torch package (default: this
checkout), for example an unpacked ``git archive`` of another commit or an
edited copy of it. The inputs are made once, as chip_smoke.py phase 3b makes
them (its manager, gyro log, lens and planes): the Y (3840x2160x1) and UV
(1920x1080x2) uint16 planes with the stacked (3*oh, ow) evals of one frame at
interpolation 11 (Robidoux). Every ROOT's kernel library is built first,
three builds at a time. Then each ROOT runs in a process of its own, in the
order given and again in reverse (A B ... B A), and reads:

- the EWA kernel's device time for Y and UV with that copy's
  ``experiments.perf_probe.cuda_ms`` (median of 10 calls, each behind an
  L2-flushing read and a device spin). A copy whose ``cuda_ewa.sample``
  still takes the (oh, ow, 4) Jacobian gets it from its own
  ``remap.ewa_jacobian`` outside the timed call, and the time of that eager
  Jacobian (``ewa_jacobian`` and a contiguous copy, the same timer) is read
  beside it;
- the largest difference from that copy's ``cuda_ewa.sample_plain`` on the
  same inputs, in codes (limit 0.01);
- the ptxas registers and spills of ``ewa_kernel<u16,C1>`` and ``<u16,C2>``.

Prints the card's name and power limit, one JSON line per reading and a
summary; writes the summary to ewa_bench.json in chip_smoke.py's output
directory (``chip_smoke.OUT_DIR``). Exits non-zero if a build, a
launch or a check fails. Not one of ``experiments.PROBES``: it compares
designs of a kernel, it does not measure the card.
"""
from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TOL = 0.01
BUILDS_AT_ONCE = 3


def _inputs(path):
    """Y and UV EWA inputs of one main-path frame at interpolation 11, saved
    to path."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gyroflow_torch.ops import cuda_coords, remap
    from gyroflow_torch.ops.kernel_params import dyn_to_torch

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = cs.make_manager(dev, tmp)
    planes = cs.make_planes()
    out = {}
    for name, (_, host) in planes.items():
        cfg, dyn, mats = cs.plane_setup(mgr, planes, 500_000, name, cs.EWA_INTERP)
        dyn_t = dyn_to_torch(dyn, dev)
        ow, oh = cfg.out_buffer
        oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                                torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
        factor = torch.clamp_min(1.0 - dyn_t.lens_correction_amount, 0.001)
        out_f = (dyn_t.f[0] / dyn_t.fov / factor, dyn_t.f[1] / dyn_t.fov / factor)
        x, y, idx = remap.ewa_stack(ox, oy, mats, cfg, dyn_t, (ow / 2.0, oh / 2.0), out_f)
        u3, v3, valid3 = cuda_coords.project_plain(x, y, idx, mats, cfg, dyn)
        u3, v3 = remap.coords_post_uv(u3, v3, cfg)
        img = torch.from_numpy(host)
        out[name] = {"img": img, "u3": u3.cpu(), "v3": v3.cpu(), "valid3": valid3.cpu(),
                     "bg": cs.plane_bg(dyn, img), "src_rect": tuple(cfg.src_rect),
                     "coeffs": remap._ewa_coeffs_of(dyn), "limit": cs.MAXV}
    torch.save(out, path)
    print(json.dumps({"inputs": path}))


def _build(root):
    """Build ROOT's kernel library (run in a process of its own); ptxas
    reports only when this process built it."""
    sys.path.insert(0, str(root))
    from gyroflow_torch import _build as b
    t0 = time.perf_counter()
    b.build(verbose=True)
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    ptxas = {k: v for k, v in cs.ptxas_summary(b.build_log).items() if k.startswith("ewa")}
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": ptxas}))


def _time(root, path):
    """Time and check ROOT's EWA kernel on the saved inputs (a process of
    its own)."""
    import torch

    sys.path.insert(0, str(root))
    import gyroflow_torch
    from gyroflow_torch.experiments import perf_probe
    from gyroflow_torch.ops import cuda_ewa, remap

    if Path(gyroflow_torch.__file__).resolve().parent != (Path(root) / "gyroflow_torch").resolve():
        raise RuntimeError(f"imported {gyroflow_torch.__file__}, not the copy in {root}")
    takes_jac = "jac" in inspect.signature(cuda_ewa.sample).parameters
    dev = torch.device("cuda", 0)
    res = {"interface": "jac" if takes_jac else "evals"}
    for name, d in torch.load(path).items():
        img, u3, v3, valid3 = (d[k].to(dev) for k in ("img", "u3", "v3", "valid3"))
        tail = (d["bg"], d["src_rect"], d["coeffs"], d["limit"])
        if takes_jac:
            u, v, valid, jac = remap.ewa_jacobian(u3, v3, valid3)
            args = (img, u, v, jac.contiguous(), valid, *tail)
        else:
            oh = u3.shape[0] // 3
            args = (img, u3[:oh], v3[:oh], u3, v3, valid3, *tail)
        k = cuda_ewa.sample(*args)
        p = cuda_ewa.sample_plain(*args)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        if not (bool(torch.isfinite(k).all()) and err <= TOL):
            raise AssertionError(f"{root} {name}: EWA kernel off its plain version by {err}")
        res[name] = {"ms": perf_probe.cuda_ms(lambda: cuda_ewa.sample(*args), dev),
                     "max_err": err}
        if takes_jac:
            res[name]["jacobian_ms"] = perf_probe.cuda_ms(
                lambda: remap.ewa_jacobian(u3, v3, valid3)[3].contiguous(), dev)
    res["Y+UV ms"] = res["Y"]["ms"] + res["UV"]["ms"]
    print(json.dumps(res))


def _run(args):
    res = subprocess.run([sys.executable, __file__, *args], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"ewa_bench {' '.join(args)} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(roots) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ewa_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    roots = [str(Path(r).resolve()) for r in roots] or [str(REPO)]
    # BUILDS_AT_ONCE libraries at a time (each runs one nvcc per source)
    builds, failed, pending, running = {}, [], list(roots), []
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
        _run(["--inputs", path])
        for r in roots + roots[::-1]:
            readings[r].append(_run(["--time", r, path]))
            print(json.dumps({"root": r, **readings[r][-1]}), flush=True)
    summary = {"card": smi, "roots": [
        {"root": r, "interface": readings[r][0]["interface"], "ptxas": builds[r]["ptxas"],
         "Y ms": [x["Y"]["ms"] for x in readings[r]],
         "UV ms": [x["UV"]["ms"] for x in readings[r]],
         "Y+UV ms": statistics.mean(x["Y+UV ms"] for x in readings[r]),
         "jacobian Y+UV ms": (statistics.mean(x["Y"]["jacobian_ms"] + x["UV"]["jacobian_ms"]
                                              for x in readings[r])
                              if readings[r][0]["interface"] == "jac" else None),
         "max_err": max(max(x["Y"]["max_err"], x["UV"]["max_err"]) for x in readings[r])}
        for r in roots]}
    sys.path.insert(0, str(REPO))
    from chip_smoke import OUT_DIR
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ewa_bench.json").write_text(json.dumps(summary, indent=1))
    print(smi)
    print(json.dumps(summary))
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
