#!/usr/bin/env python3
"""Time the sampler kernel (csrc/sampler.cu) and forms of the coords kernel
(csrc/coords.cu) of one or more copies of gyroflow_torch on the 4K main-path
inputs, on one CUDA card.

    python3 sampler_bench.py [ROOT ...]

Each ROOT is a directory holding a gyroflow_torch package (default: this
repo), for example an unpacked ``git archive`` of another commit or an edited
copy of it. The inputs are made once, as chip_smoke.py phase 3 makes them
(its manager, gyro log, lens and planes): the Y (3840x2160x1) and UV
(1920x1080x2) uint16 planes with the u, v and valid maps of one lanczos4
frame, and the coords kernel's x, y, idx and matrices of that frame, of
that frame with other lenses (chip_smoke.py phase 8's: the fisheye with the
digital lenses gopro_superview, digital_stretch and gopro_warp, and the
gopro model, whose Newton loop and fixed points run per pixel) and of a
frame of chip_smoke.py phase 9's Sony clip (sony lens, IBIS, a 9x9 mesh and
FPD). Every ROOT's kernel library is built first, three builds at a time.
Then each ROOT runs in a process of its own, in the order given and again in
reverse (A B ... B A), and reads:

- the device time for Y and UV of the sampler, of the coords kernel's
  fisheye plain form, of its forms with those lenses and (where the copy's
  ``cuda_coords.project`` takes a mesh) of its mesh form, both the
  projection and the full-plane rolling-shutter probe (``remap.mesh_probe``'s
  launch: every pixel through the centre matrix row), with that copy's
  ``experiments.perf_probe.cuda_ms`` (median of 10 calls, each behind an
  L2-flushing read and a device spin);
- the largest difference from that copy's ``cuda_sampler.sample_plain`` on
  the same inputs, in codes (limit 0.01), and from its
  ``cuda_coords.project_plain``, in px over valid pixels with the valid
  masks identical (limit 1e-4; the other lenses' and the mesh forms
  bit-identical). A copy with ``cuda_coords.pack_mesh`` gets the mesh
  buffer packed by it, an older copy the reference buffer;
- the ptxas registers and spills of ``sampler_kernel<u16,C1,8>``,
  ``<u16,C2,8>`` and of the coords kernel's fisheye plain and digital forms,
  its gopro form and the sony mesh form, for a grid height read at run time
  and for the 9 rows of the Sony clip's grid where the copy has that form
  (a copy from before the mesh form was split off reports its two forms
  under the same names).

Prints the card's name and power limit, one JSON line per reading and a
summary; writes chiprun_out/sampler_bench.json. Exits non-zero if a build,
a launch or a check fails.
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

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"
TOL = 0.01
COORDS_TOL_PX = 1e-4
BUILDS_AT_ONCE = 3
# the other lenses timed on the main-path frame: (main model, digital lens)
LENSES = (("opencv_fisheye", "gopro_superview"), ("opencv_fisheye", "digital_stretch"),
          ("opencv_fisheye", "gopro_warp"), ("gopro", None))
# the coords kernel's forms by their mangled names: this tree's three forms,
# then a tree whose kernel had two (plain, and digital with the mesh)
COORDS_FORMS = {"coords": ("coords_kernelILi0ELb0ELb0EE", "coords_kernelILi0ELb0EE"),
                "coords<opencv_fisheye,digital>": ("coords_kernelILi0ELb1ELb0EE",
                                                   "coords_kernelILi0ELb1EE"),
                "coords<gopro>": ("coords_kernelILi8ELb0ELb0EE", "coords_kernelILi8ELb0EE"),
                "coords<sony,mesh>": ("coords_kernelILi6ELb1ELb1EE", "coords_kernelILi6ELb1EE"),
                "coords<sony,mesh,9 rows>": ("coords_mesh_kernelILi6ELi9EE",)}


def lens_key(model, digital):
    return model if digital is None else f"{model}+{digital}"


def cs_out_cf(cfg, dyn_t):
    """(out_c, out_f) as remap._remap builds them."""
    import torch
    factor = torch.clamp_min(1.0 - dyn_t.lens_correction_amount, 0.001)
    return ((cfg.output_width / 2.0, cfg.output_height / 2.0),
            (dyn_t.f[0] / dyn_t.fov / factor, dyn_t.f[1] / dyn_t.fov / factor))


def _inputs(path):
    """Y and UV sampler inputs of one main-path lanczos4 frame, saved to path."""
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from gyroflow_torch.ops import cuda_coords, remap
    from gyroflow_torch.ops.kernel_params import dyn_to_torch

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = cs.make_manager(dev, tmp)
        sony = cs.make_sony_manager(dev, tmp)
    planes = cs.make_planes()
    out = {}
    for name, (_, host) in planes.items():
        cfg, dyn, mats = cs.plane_setup(mgr, planes, 500_000, name)
        dyn_t = dyn_to_torch(dyn, dev)
        ow, oh = cfg.out_buffer
        oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32, device=dev),
                                torch.arange(ow, dtype=torch.float32, device=dev), indexing="ij")
        x, y, idx = remap.coords_pre(ox, oy, mats, cfg, dyn_t, *cs_out_cf(cfg, dyn_t))
        u, v, valid = cuda_coords.project_plain(x, y, idx, mats, cfg, dyn)
        u, v = remap.coords_post_uv(u, v, cfg)
        img = torch.from_numpy(host)
        out[name] = {"img": img, "u": u.cpu(), "v": v.cpu(), "valid": valid.cpu(),
                     "bg": cs.plane_bg(dyn, img), "src_rect": tuple(cfg.src_rect),
                     "limit": cs.MAXV, "x": x.cpu(), "y": y.cpu(), "idx": idx.cpu(),
                     "mats": mats.cpu(), "cfg": cfg, "dyn": dyn, "lenses": {}}
        for model, digital in LENSES:
            dcfg, ddyn = cs.with_lens(cfg, dyn, model, digital)
            ddyn_t = dyn_to_torch(ddyn, dev)
            dx, dy, didx = remap.coords_pre(ox, oy, mats, dcfg, ddyn_t, *cs_out_cf(dcfg, ddyn_t))
            out[name]["lenses"][lens_key(model, digital)] = {
                "x": dx.cpu(), "y": dy.cpu(), "idx": didx.cpu(), "cfg": dcfg, "dyn": ddyn}
        cfg, dyn, mats = cs.plane_setup(sony, planes, 500_000, name)
        mesh = cs.plane_mesh(sony, 500_000)
        ref = np.asarray(sony.frame_transform_at(sony._adjusted_ts_ms(500_000)).mesh_data,
                         np.float32)
        dyn_t = dyn_to_torch(dyn, dev)
        x, y, idx = remap.coords_pre(ox, oy, mats, cfg, dyn_t, *cs_out_cf(cfg, dyn_t), mesh=mesh)
        out[name]["mesh"] = {"x": x.cpu(), "y": y.cpu(), "idx": idx.cpu(), "mats": mats.cpu(),
                             "mesh": torch.from_numpy(ref), "cfg": cfg, "dyn": dyn}
    torch.save(out, path)
    print(json.dumps({"inputs": path}))


def _same(k, p):
    """Kernel and plain outputs bit-identical, NaN where the other is NaN."""
    import torch
    return all(torch.equal(a, b) or (a.dtype.is_floating_point
                                     and torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a.nan_to_num(), b.nan_to_num()))
               for a, b in zip(k, p))


def _build(root):
    """Build ROOT's kernel library (run in a process of its own); ptxas
    reports only when this process built it."""
    sys.path.insert(0, str(root))
    from gyroflow_torch import _build as b
    t0 = time.perf_counter()
    b.build(verbose=True)
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    ptxas = {k: v for k, v in cs.ptxas_summary(b.build_log).items() if k.startswith("sampler")}
    current = None
    for ln in b.build_log.splitlines():
        if "Compiling entry function" in ln:
            current = next((k for k, names in COORDS_FORMS.items()
                            if any(m in ln for m in names)), None)
        elif current and ("spill" in ln or "registers" in ln):
            ptxas[current] = (ptxas.get(current, "") + " " + ln.split(":")[-1].strip()).strip()
    print(json.dumps({"build_s": time.perf_counter() - t0, "ptxas": ptxas}))


def _time(root, path):
    """Time and check ROOT's sampler on the saved inputs (a process of its own)."""
    import torch

    sys.path.insert(0, str(root))
    import gyroflow_torch
    from gyroflow_torch.experiments import perf_probe
    from gyroflow_torch.ops import cuda_coords, cuda_sampler

    if Path(gyroflow_torch.__file__).resolve().parent != (Path(root) / "gyroflow_torch").resolve():
        raise RuntimeError(f"imported {gyroflow_torch.__file__}, not the copy in {root}")
    dev = torch.device("cuda", 0)
    res = {}
    for name, d in torch.load(path, weights_only=False).items():
        img, u, v, valid = (d[k].to(dev) for k in ("img", "u", "v", "valid"))
        args = (img, u, v, valid, d["bg"], d["src_rect"], 8, d["limit"])
        k = cuda_sampler.sample(*args)
        p = cuda_sampler.sample_plain(*args)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        if not (bool(torch.isfinite(k).all()) and err <= TOL):
            raise AssertionError(f"{root} {name}: sampler off its plain version by {err}")
        res[name] = {"ms": perf_probe.cuda_ms(lambda: cuda_sampler.sample(*args), dev),
                     "max_err": err}
        cargs = (*(d[k].to(dev) for k in ("x", "y", "idx", "mats")), d["cfg"], d["dyn"])
        k = cuda_coords.project(*cargs)
        p = cuda_coords.project_plain(*cargs)
        torch.cuda.synchronize()
        cerr = max(float((a - b).abs()[k[2]].max()) for a, b in zip(k[:2], p[:2]))
        if not (torch.equal(k[2], p[2]) and cerr <= COORDS_TOL_PX):
            raise AssertionError(f"{root} {name}: coords off its plain version by {cerr} px")
        res[name].update(coords_ms=perf_probe.cuda_ms(lambda: cuda_coords.project(*cargs), dev),
                         coords_max_err=cerr)
        mats = d["mats"].to(dev)
        for key, g in d["lenses"].items():
            largs = (*(g[k].to(dev) for k in ("x", "y", "idx")), mats, g["cfg"], g["dyn"])
            if not _same(cuda_coords.project(*largs), cuda_coords.project_plain(*largs)):
                raise AssertionError(f"{root} {name}: the {key} form differs from its plain "
                                     f"version")
            res[name][f"{key}_ms"] = perf_probe.cuda_ms(lambda: cuda_coords.project(*largs), dev)
        if "mesh" in inspect.signature(cuda_coords.project).parameters:
            m = d["mesh"]
            mesh = m["mesh"]
            if hasattr(cuda_coords, "pack_mesh"):
                mesh = torch.from_numpy(cuda_coords.pack_mesh(mesh, m["cfg"]))
            mx, my, midx, mmats, mesh = (t.to(dev) for t in (*(m[k] for k in (
                "x", "y", "idx", "mats")), mesh))
            c = mmats.shape[0] // 2
            margs = (mx, my, midx, mmats, m["cfg"], m["dyn"], mesh)
            # remap.mesh_probe's launch: every pixel through the centre row
            pargs = (mx, my, torch.zeros_like(midx), mmats[c:c + 1].contiguous(), m["cfg"],
                     m["dyn"], mesh)
            for label, a in (("mesh", margs), ("mesh probe", pargs)):
                if not _same(cuda_coords.project(*a), cuda_coords.project_plain(*a)):
                    raise AssertionError(f"{root} {name}: the {label} form differs from its "
                                         f"plain version")
            res[name]["mesh_coords_ms"] = perf_probe.cuda_ms(
                lambda: cuda_coords.project(*margs), dev)
            res[name]["mesh_probe_ms"] = perf_probe.cuda_ms(
                lambda: cuda_coords.project(*pargs), dev)
    res["Y+UV ms"] = res["Y"]["ms"] + res["UV"]["ms"]
    res["coords Y+UV ms"] = res["Y"]["coords_ms"] + res["UV"]["coords_ms"]
    for key in map(lambda ld: lens_key(*ld), LENSES):
        res[f"{key} Y+UV ms"] = res["Y"][f"{key}_ms"] + res["UV"][f"{key}_ms"]
    if "mesh_coords_ms" in res["Y"]:
        res["mesh coords Y+UV ms"] = res["Y"]["mesh_coords_ms"] + res["UV"]["mesh_coords_ms"]
        res["mesh probe Y+UV ms"] = res["Y"]["mesh_probe_ms"] + res["UV"]["mesh_probe_ms"]
    print(json.dumps(res))


def _run(args):
    res = subprocess.run([sys.executable, __file__, *args], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"sampler_bench {' '.join(args)} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(roots) -> int:
    import torch
    if not torch.cuda.is_available():
        print("sampler_bench: no CUDA device", file=sys.stderr)
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
    keys = [lens_key(*ld) for ld in LENSES]
    summary = {"card": smi, "roots": [
        {"root": r, "ptxas": builds[r]["ptxas"],
         "Y ms": [x["Y"]["ms"] for x in readings[r]],
         "UV ms": [x["UV"]["ms"] for x in readings[r]],
         "Y+UV ms": statistics.mean(x["Y+UV ms"] for x in readings[r]),
         "coords Y+UV ms": [x["coords Y+UV ms"] for x in readings[r]],
         **{f"{k} Y ms": [x["Y"][f"{k}_ms"] for x in readings[r]] for k in keys},
         **{f"{k} Y+UV ms": [x[f"{k} Y+UV ms"] for x in readings[r]] for k in keys},
         "mesh coords Y ms": [x["Y"].get("mesh_coords_ms") for x in readings[r]],
         "mesh coords Y+UV ms": [x.get("mesh coords Y+UV ms") for x in readings[r]],
         "mesh probe Y ms": [x["Y"].get("mesh_probe_ms") for x in readings[r]],
         "mesh probe Y+UV ms": [x.get("mesh probe Y+UV ms") for x in readings[r]],
         "max_err": max(max(x["Y"]["max_err"], x["UV"]["max_err"]) for x in readings[r])}
        for r in roots]}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "sampler_bench.json").write_text(json.dumps(summary, indent=1))
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
