#!/usr/bin/env python3
"""Time the sampler kernel (csrc/sampler.cu), forms of the coords kernel
(csrc/coords.cu), the fused kernel (csrc/fused.cu) and the self-contained
coords kernel (gf_coords_gen) of one or more copies of gyroflow_torch on the
4K main-path inputs, on one CUDA card.

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
- the device time for Y and UV of the fused kernel (``cuda_fused.remap_fused``
  on the frame's x, y, idx: its fisheye form, and its any-lens form on the
  fisheye + gopro_superview frame) and of the self-contained coords kernel
  (``cuda_coords.project_gen``, fisheye, the whole plane), the same timer;
  each held to that copy's plain version (``remap_fused_plain``: at most
  0.01 codes, the largest difference printed; ``project_gen_plain``:
  bit-identical);
- the ptxas registers and spills of ``sampler_kernel<u16,C1,8>``,
  ``<u16,C2,8>`` and of the coords kernel's fisheye plain and digital forms,
  its gopro form and the sony mesh form, for a grid height read at run time
  and for the 9 rows of the Sony clip's grid where the copy has that form
  (a copy from before the mesh form was split off reports its two forms
  under the same names), of the fused kernel's fisheye and any-lens forms
  and of ``coords_gen_kernel<opencv_fisheye>``;
- the SASS instructions of ``coords_gen_kernel<opencv_fisheye>`` and of the
  fused kernel's fisheye form ``<u16,C1,8>`` (``cuobjdump -sass`` on the
  copy's library: the kernel's instructions in all, and its FP32, MUFU,
  load and branch instructions), each kernel's SASS written to
  chiprun_out/sass/.

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
# the digital lens whose frame the fused kernel's any-lens form is timed on
FUSED_ANY_LENS = ("opencv_fisheye", "gopro_superview")
# the kernels whose SASS is counted, by their mangled names
SASS_KERNELS = {"coords_gen<opencv_fisheye>": "coords_gen_kernelILi0EE",
                "fused<u16,C1,8>": "fused_kernelItLi1ELi8ELb0EE"}
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


def _sass_instructions(body):
    """(address, predicate, opcode, operands) of each instruction of a
    cuobjdump -sass listing."""
    import re
    return [(int(m.group(1), 16), m.group(2).strip(), m.group(3), m.group(4).strip())
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?)([A-Z0-9_.]+)"
                                 r"([^;]*);", body)]


def main_path_instructions(ins):
    """The instructions one thread issues on the kernel's longest path with
    no IBIS, no underwater refraction and every IEEE division and square
    root on its fast path: a conditional branch is always taken where it
    skips a slow-path CALL within its next 8 instructions or follows a test
    of the IBIS (0x100) or underwater (0x800) flag for the flag's absence,
    and either way elsewhere, whichever issues more (so the walk runs the
    rolling-shutter probe and both chains of the self-contained coords
    kernel); a path ends at an EXIT that is not predicated, and a branch
    back to an address on the path (a loop) ends it too. Returns
    (instructions, double-precision instructions among them): the latter
    are sin and cos's slow range reduction, 0 on the path this walk means."""
    import re
    import sys as _sys
    at = {a: i for i, (a, *_r) in enumerate(ins)}
    forced, flag_preds = set(), set()
    for i, (a, pred, op, args) in enumerate(ins):
        dest = args.split(",")[0].strip()
        if re.match(r"U?P\d$", dest):
            if op.lstrip("U").startswith("LOP3") and re.match(r"U?P\d, U?RZ, U?R\d+, (0x100|0x800),", args):
                flag_preds.add(dest)
            else:
                flag_preds.discard(dest)
        if op.startswith("BRA") and pred:
            tgt = int(re.search(r"0x([0-9a-f]+)", args).group(1), 16)
            if any(x[2].startswith("CALL") for x in ins[i + 1:i + 9] if x[0] < tgt) \
                    or (pred.startswith("@!") and pred[2:] in flag_preds):
                forced.add(a)
    memo, on_path = {}, set()
    _sys.setrecursionlimit(max(_sys.getrecursionlimit(), 4 * len(ins) + 100))

    def longest(i):
        """(instructions, f64 instructions) from instruction i to the end."""
        if i >= len(ins) or i in on_path:
            return 0, 0
        if i in memo:
            return memo[i]
        on_path.add(i)
        a, pred, op, args = ins[i]
        here = (1, int(op.startswith("D")))
        if op.startswith("EXIT") and not pred:
            rest = (0, 0)
        elif op.startswith("BRA"):
            tgt = at[int(re.search(r"0x([0-9a-f]+)", args).group(1), 16)]
            if not pred or a in forced:
                rest = longest(tgt)
            else:
                rest = max(longest(i + 1), longest(tgt))
        else:
            rest = longest(i + 1)
        on_path.discard(i)
        memo[i] = (here[0] + rest[0], here[1] + rest[1])
        return memo[i]

    return longest(0)


def sass_counts(lib_path, cuobjdump, tag):
    """The SASS of SASS_KERNELS in the library: per kernel, its instructions
    in all and by class, and those of its main path
    (main_path_instructions); each kernel's listing goes to
    chiprun_out/sass/."""
    import re
    res = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True)
    sections = re.split(r"\n\s*Function : ", res.stdout)
    out = {}
    (OUT_DIR / "sass").mkdir(parents=True, exist_ok=True)
    for key, mangled in SASS_KERNELS.items():
        body = next((sec for sec in sections if mangled in sec.split("\n", 1)[0]), None)
        if body is None:
            continue
        (OUT_DIR / "sass" / f"{tag}_{mangled}.sass").write_text(body)
        ins = _sass_instructions(body)
        base = [op.split(".")[0] for _, _, op, _ in ins]
        main, f64 = main_path_instructions(ins)
        out[key] = {"instructions": len(ins), "main_path": main, "main_path_f64": f64,
                    "fp32": sum(o in ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET",
                                      "FCHK", "FRND", "F2I", "I2F", "F2F") for o in base),
                    "mufu": base.count("MUFU"),
                    "loads": sum(o in ("LDG", "LDS", "LDC", "LD", "ULDC") for o in base),
                    "branches": sum(o in ("BRA", "CALL", "RET", "BSSY", "BSYNC", "EXIT")
                                    for o in base)}
    return out


def _build(root):
    """Build ROOT's kernel library (run in a process of its own); ptxas
    reports only when this process built it."""
    sys.path.insert(0, str(root))
    from gyroflow_torch import _build as b
    t0 = time.perf_counter()
    lib_path = b.build(verbose=True)
    build_s = time.perf_counter() - t0
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    ptxas = {k: v for k, v in cs.ptxas_summary(b.build_log).items()
             if k.startswith(("sampler", "fused<u16", "coords_gen"))}
    current = None
    for ln in b.build_log.splitlines():
        if "Compiling entry function" in ln:
            current = next((k for k, names in COORDS_FORMS.items()
                            if any(m in ln for m in names)), None)
        elif current and ("spill" in ln or "registers" in ln):
            ptxas[current] = (ptxas.get(current, "") + " " + ln.split(":")[-1].strip()).strip()
    cuobjdump = str(Path(b.find_nvcc()).with_name("cuobjdump"))
    print(json.dumps({"build_s": build_s, "ptxas": ptxas,
                      "sass": sass_counts(lib_path, cuobjdump, Path(root).name)}))


def _time(root, path):
    """Time and check ROOT's sampler on the saved inputs (a process of its own)."""
    import torch

    sys.path.insert(0, str(root))
    import gyroflow_torch
    from gyroflow_torch.experiments import perf_probe
    from gyroflow_torch.ops import cuda_coords, cuda_fused, cuda_sampler
    from gyroflow_torch.ops.kernel_params import dyn_to_torch

    if Path(gyroflow_torch.__file__).resolve().parent != (Path(root) / "gyroflow_torch").resolve():
        raise RuntimeError(f"imported {gyroflow_torch.__file__}, not the copy in {root}")
    dev = torch.device("cuda", 0)
    res = {}

    def staged_share(fn):
        """The share of the fused kernel's tiles that staged their footprint
        in one call, where the copy's library counts them
        (gf_fused_tile_counts), else None."""
        import ctypes
        from gyroflow_torch import _build
        counts = getattr(_build.lib(), "gf_fused_tile_counts", None)
        if counts is None:
            return None
        counts.argtypes = [ctypes.c_void_p, ctypes.c_int]
        buf = (ctypes.c_ulonglong * 2)()
        torch.cuda.synchronize()
        counts(ctypes.addressof(buf), 1)
        fn()
        torch.cuda.synchronize()
        counts(ctypes.addressof(buf), 1)
        return buf[1] / max(buf[0], 1)

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
        fargs = (img, *cargs[:4], d["cfg"], d["dyn"], d["bg"], d["limit"])
        any_lens = d["lenses"][lens_key(*FUSED_ANY_LENS)]
        aargs = (img, *(any_lens[k].to(dev) for k in ("x", "y", "idx")), mats, any_lens["cfg"],
                 any_lens["dyn"], d["bg"], d["limit"])
        for label, a in (("fused", fargs), ("fused_any_lens", aargs)):
            k = cuda_fused.remap_fused(*a)
            p = cuda_fused.remap_fused_plain(*a)
            torch.cuda.synchronize()
            ferr = float((k - p).abs().max())
            if not (bool(torch.isfinite(k).all()) and ferr <= TOL):
                raise AssertionError(f"{root} {name}: {label} off its plain version by {ferr}")
            res[name][f"{label}_ms"] = perf_probe.cuda_ms(lambda: cuda_fused.remap_fused(*a),
                                                          dev)
            res[name][f"{label}_max_err"] = ferr
            share = staged_share(lambda: cuda_fused.remap_fused(*a))
            if share is not None:
                res[name][f"{label}_staged_share"] = share
        dyn_t = dyn_to_torch(d["dyn"], dev)
        gargs = (d["cfg"], d["dyn"], mats, d["cfg"].out_buffer[1], 0, *cs_out_cf(d["cfg"], dyn_t))
        if not _same(cuda_coords.project_gen(*gargs), cuda_coords.project_gen_plain(*gargs)):
            raise AssertionError(f"{root} {name}: project_gen differs from its plain version")
        res[name]["gen_ms"] = perf_probe.cuda_ms(lambda: cuda_coords.project_gen(*gargs), dev)
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
    for key in ("fused", "fused_any_lens", "gen"):
        res[f"{key} Y+UV ms"] = res["Y"][f"{key}_ms"] + res["UV"][f"{key}_ms"]
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
        {"root": r, "ptxas": builds[r]["ptxas"], "sass": builds[r]["sass"],
         **{f"{k} Y ms": [x["Y"][f"{k}_ms"] for x in readings[r]]
            for k in ("fused", "fused_any_lens", "gen")},
         **{f"{k} Y+UV ms": [x[f"{k} Y+UV ms"] for x in readings[r]]
            for k in ("fused", "fused_any_lens", "gen")},
         "fused max_err": max(max(x[n][f"{k}_max_err"] for n in ("Y", "UV")
                                  for k in ("fused", "fused_any_lens")) for x in readings[r]),
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
