"""gyroflow_torch's self-contained coords (``cuda_coords.project_gen``) vs the
JAX package's ``pallas_coords.project_tiles_gen``, on the CPU.

- ``project_gen`` on CPU tensors (its plain version) against
  ``project_tiles_gen`` with the Pallas kernel in interpret mode, untiled
  with ``pallas_sampler.out_untileize_c``: Y, UV with source/output rects,
  horizontal rolling shutter, an eps ``pos_dx`` (an EWA finite-difference
  eval) and a band with ``oy0 > 0`` and ``out_rows < oh``.
- ``project_gen`` against ``remap.coords_pre`` + ``cuda_coords.project`` on
  the same band (the split path it replaces): bit-identical on the CPU.
- Every main model (one case: opencv_standard); the configurations the
  kernel does not compute (lens correction, mesh, digital lens, as JAX
  gates project_tiles_gen) raise ValueError instead of a different answer.
- ``project_gen`` on an EWA configuration, EWA's stacked evals: on the CPU
  bit-identical to ``remap.ewa_stack`` + ``project_plain`` (whole planes and
  bands at an odd ``oy0``, the same-row Jacobian and ``ewa_ref_jac``); the
  number of evals follows the interpolation.
- ``remap.remap_plane_cuda``'s route through ``project_gen``: on CPU tensors
  bit-identical to ``remap_plane`` for a fisheye plane of the 4K shape (Y,
  UV with its source and output rects, a band at ``oy0 > 0``, a table of
  one matrix row), at lanczos4 and at EWA 11 (``ewa_ref_jac`` too), one
  ``project_gen`` call a plane and no ``project`` call; the first
  ``gf.eager`` span of each plane notes "gen" there and "pre" for each form
  that keeps ``coords_pre`` (mesh and focal plane, lens correction, a
  digital lens, each also at EWA, ``fused=True``).
- ``remap.plane_route`` over the same eight forms: the route each takes and
  whether its rolling-shutter probe runs on the coords kernel (the mesh
  plane's alone).

Tolerances: u/v within 0.05 px (the ROADMAP's coordinate tolerance; the
JAX kernel's in-kernel probe and XLA round the same chain a few ulp apart),
valid masks identical.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import pallas_coords, pallas_sampler
from gyroflow_tpu.ops.kernel_params import HORIZONTAL_RS
from gyroflow_torch import trace
from gyroflow_torch.ops import cuda_coords
from gyroflow_torch.ops import kernel_params as tkp
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.ops.kernel_params import (FIX_COLOR_RANGE, HAS_DIGITAL_LENS, HAS_MESH_DATA,
                                              HAS_OUTPUT_RECT, HAS_SOURCE_RECT, dyn_to_torch)

from test_remap_golden import make_image
from test_torch_coords import _out_c_f
from test_torch_mesh import _mesh_case
from test_torch_remap import K, _rot, lens_kw, make_case
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

UV_TOL_PX = 0.05
TILE_H, TILE_W = 8, 128


def _jax_gen(cfg, dyn, mats, out_rows, oy0, pos_dx=0.0, pos_dy=0.0):
    """project_tiles_gen on the (ceil(out_rows/8), ceil(ow/128)) tile grid,
    untiled to (out_rows, ow) u, v, valid."""
    ow = cfg.out_buffer[0]
    ny, nx = -(-out_rows // TILE_H), -(-ow // TILE_W)
    out_c, out_f = _out_c_f(cfg, dyn)
    u, v, valid, ov = pallas_coords.project_tiles_gen(
        cfg, dyn, jnp.asarray(mats), ny, nx, TILE_H, TILE_W, oy0, out_c, out_f,
        pos_dx=pos_dx, pos_dy=pos_dy)
    assert not bool(ov), "matrix window overflow at test size"
    spec = SimpleNamespace(grid=(ny, nx), tile_h=TILE_H, tile_w=TILE_W,
                           out_height=out_rows, out_width=ow)
    return [np.array(pallas_sampler.out_untileize_c(spec, jnp.asarray(a, jnp.float32)[None])[0])
            for a in (u, v, valid)]


# (plane, make_case kwargs, out_rows or None for the whole plane, oy0, pos_dx)
CASES = [
    ("Y", {}, None, 0, 0.0),
    ("UV", dict(translation2d=(1.5, -2.0)), None, 0, 0.01),
    ("Y", dict(flags=HORIZONTAL_RS, fov=1.2), 24, 16, 0.0),
    ("Y", lens_kw("opencv_standard"), 40, 8, 0.0),      # a main model other than fisheye
]


@pytest.mark.parametrize("plane,kw,out_rows,oy0,pos_dx", CASES)
def test_project_gen_vs_project_tiles_gen(plane, kw, out_rows, oy0, pos_dx):
    cfg, dyn, pcfg, pdyn, mats, _ = make_case(plane, **kw)
    rows = out_rows or cfg.out_buffer[1]
    ju, jv, jvalid = _jax_gen(cfg, dyn, mats, rows, oy0, pos_dx=pos_dx)
    out_c, out_f = _out_c_f(cfg, dyn)
    tu, tv, tvalid = cuda_coords.project_gen(pcfg, pdyn, torch.from_numpy(mats), rows, oy0,
                                             out_c, out_f, pos_dx=pos_dx)
    assert tuple(tu.shape) == (rows, cfg.out_buffer[0]) and tvalid.dtype == torch.bool
    np.testing.assert_array_equal(tvalid.numpy(), jvalid > 0.5)
    ok = jvalid > 0.5
    assert ok.mean() > 0.5
    assert np.abs(tu.numpy() - ju)[ok].max() <= UV_TOL_PX
    assert np.abs(tv.numpy() - jv)[ok].max() <= UV_TOL_PX


@pytest.mark.parametrize("plane,kw,out_rows,oy0,pos_dx", CASES)
def test_project_gen_is_coords_pre_plus_project(plane, kw, out_rows, oy0, pos_dx):
    _, dyn, pcfg, pdyn, mats, _ = make_case(plane, **kw)
    ow, oh = pcfg.out_buffer
    rows = out_rows or oh
    out_c, out_f = _out_c_f(pcfg, dyn)
    m = torch.from_numpy(mats)
    dt = dyn_to_torch(pdyn, torch.device("cpu"))
    oy, ox = torch.meshgrid(torch.arange(oh, dtype=torch.float32),
                            torch.arange(ow, dtype=torch.float32), indexing="ij")
    x, y, idx = tremap.coords_pre(ox + pos_dx, oy, m, pcfg, dt, out_c, out_f)
    want = cuda_coords.project(x[oy0:oy0 + rows].contiguous(), y[oy0:oy0 + rows].contiguous(),
                               idx[oy0:oy0 + rows].contiguous(), m, pcfg, pdyn)
    got = cuda_coords.project_gen(pcfg, pdyn, m, rows, oy0, out_c, out_f, pos_dx=pos_dx)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("change", [
    dict(lens_correction=True), dict(flags=HAS_MESH_DATA), dict(flags=HAS_DIGITAL_LENS),
    dict(digital_lens="gopro_superview")])
def test_gated_configurations_raise(change):
    _, dyn, pcfg, pdyn, mats, _ = make_case("Y")
    out_c, out_f = _out_c_f(pcfg, dyn)
    with pytest.raises(ValueError, match="project_tiles_gen"):
        cuda_coords.project_gen(pcfg._replace(**change), pdyn, torch.from_numpy(mats), 8, 0,
                                out_c, out_f)


@pytest.mark.parametrize("plane,kw,out_rows,oy0,ref_jac", [
    ("Y", {}, None, 0, False), ("UV", dict(translation2d=(1.5, -2.0)), None, 0, False),
    ("Y", dict(flags=HORIZONTAL_RS, fov=1.2), 23, 17, False), ("Y", {}, 31, 9, True),
    ("UV", {}, None, 0, True)])
def test_project_gen_ewa_is_ewa_stack_plus_project(plane, kw, out_rows, oy0, ref_jac):
    """project_gen at EWA 11 on the CPU: the (3 * rows, ow) stacked evals
    with the bits of ewa_stack on the band's grid and project_plain, in
    the same-row mode and with ewa_ref_jac (a row probe per eval)."""
    _, dyn, pcfg, pdyn, mats, _ = make_case(plane, interpolation=11, **kw)
    pcfg = pcfg._replace(ewa_ref_jac=ref_jac)
    ow, oh = pcfg.out_buffer
    rows = out_rows or oh
    out_c, out_f = _out_c_f(pcfg, dyn)
    m = torch.from_numpy(mats)
    dt = dyn_to_torch(pdyn, torch.device("cpu"))
    oy, ox = torch.meshgrid(torch.arange(oy0, oy0 + rows, dtype=torch.float32),
                            torch.arange(ow, dtype=torch.float32), indexing="ij")
    want = cuda_coords.project_plain(*tremap.ewa_stack(ox, oy, m, pcfg, dt, out_c, out_f), m,
                                     pcfg, pdyn)
    got = cuda_coords.project_gen(pcfg, pdyn, m, rows, oy0, out_c, out_f)
    assert tuple(got[0].shape) == (3 * rows, ow) and got[2].dtype == torch.bool
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("interpolation,evals", [(8, 1), (11, 3)])
def test_project_gen_evals_follow_interpolation(interpolation, evals):
    """project_gen reads the number of evals from the configuration: one
    at lanczos4, EWA's three stacked evals at interpolation 11, counted in
    gf.coords.points and (EWA only) gf.coords.gen_ewa_planes."""
    _, dyn, pcfg, pdyn, mats, _ = make_case("Y", interpolation=interpolation)
    out_c, out_f = _out_c_f(pcfg, dyn)
    trace.enable()
    try:
        got = cuda_coords.project_gen(pcfg, pdyn, torch.from_numpy(mats), 8, 3, out_c, out_f)
        counts = trace.counts()
    finally:
        trace.disable()
    ow = pcfg.out_buffer[0]
    assert all(tuple(t.shape) == (evals * 8, ow) for t in got)
    assert counts["gf.coords.points"] == evals * 8 * ow
    assert counts.get("gf.coords.gen_ewa_planes", 0) == (evals == 3)


def test_gen_args_layout():
    """The by-value GenArgs: out-rect map, translation2d and the RS clip."""
    _, _, pcfg, pdyn, _, _ = make_case("UV", flags=HORIZONTAL_RS, translation2d=(3.0, -1.0))
    g = cuda_coords.gen_args(pcfg, pdyn, 5, 0.01, 0.0)
    orx, ory, orw, orh = pcfg.out_rect
    assert g.oy0 == 5 and list(g.pos_d) == [np.float32(0.01), 0.0]
    assert list(g.map_x) == [orx, pcfg.output_width, np.float32(1.0) / np.float32(orw)]
    assert list(g.map_y) == [ory, pcfg.output_height, np.float32(1.0) / np.float32(orh)]
    assert list(g.t2d) == [3.0, -1.0] and g.lim == pcfg.width


def test_gen_args_translation_has_no_negative_zero():
    """The kernel adds translation2d straight to the out-rect map (no + 0
    for the map's out_min): gen_args sends a -0 as +0, and then the kernel's
    sum has the plain version's bits for every map value, -0 included."""
    _, _, pcfg, pdyn, _, _ = make_case("Y", translation2d=(-0.0, 2.5))
    g = cuda_coords.gen_args(pcfg, pdyn, 0, 0.0, 0.0)
    assert list(g.t2d) == [0.0, 2.5] and not np.signbit(g.t2d[0])
    f32 = np.float32
    for a in (f32(-0.0), f32(0.0), f32(1.5), f32(-3.25), f32(np.inf), f32(-np.inf)):
        for t in (f32(-0.0), f32(0.0), f32(2.5), f32(-1.0)):
            want = (a + f32(0.0)) + t
            got = a + (t + f32(0.0))
            assert np.array_equal(np.array(want).view(np.int32), np.array(got).view(np.int32))


# ---- remap_plane_cuda's route through project_gen ---------------------------

UHD_SHAPE = (192, 108)      # 3840 x 2160 at a twentieth: the 4K frame's shape


def _uhd_case(plane):
    """(port cfg, port dyn, matrices, uint16 image): a fisheye plane of the
    4K shape, the UV plane with the manager's source and output rects,
    per-row rolling-shutter matrices and limited range."""
    w, h = UHD_SHAPE
    f, fov = w * 0.62, 1.05
    cfg = tkp.KernelConfig(width=w, height=h, output_width=w, output_height=h,
                           interpolation=8, distortion_model="opencv_fisheye",
                           flags=FIX_COLOR_RANGE)
    c = 1
    if plane == "UV":
        cfg = cfg._replace(plane_index=1, source_rect=(0, 0, w // 2, h // 2),
                           output_rect=(0, 0, w // 2, h // 2), out_size=(w // 2, h // 2),
                           flags=cfg.flags | HAS_SOURCE_RECT | HAS_OUTPUT_RECT)
        c = 2
    dyn = tkp.KernelDynamics.make(f=(f, f), c=(w / 2, h / 2), k=K, fov=fov,
                                  background=(0.1, 0.5, 0.2, 1.0), max_pixel_value=1023.0,
                                  pixel_value_limit=1023.0)
    new_k = np.array([[f / fov, 0, w / 2], [0, f / fov, h / 2], [0, 0, 1.0]])
    rows = []
    for i in range(h):
        r = _rot(0.012 + 4e-4 * i, -0.018 + 2e-4 * i, 0.006)
        r[0, 1] *= -1; r[0, 2] *= -1; r[1, 0] *= -1; r[2, 0] *= -1
        rows.append(list(np.linalg.inv(new_k @ r).flatten()) + [0.0] * 5)
    ow, oh = cfg.out_buffer
    img = np.random.default_rng(3).integers(0, 1024, (oh, ow, c)).astype(np.uint16)
    return cfg, dyn, np.asarray(rows, np.float32), img


@pytest.fixture
def routes(monkeypatch):
    """Counts of the calls into project_gen and project, and the first
    gf.eager span's note of each plane, with the tracer on."""
    calls = {"project_gen": 0, "project": 0}
    for name in calls:
        fn = getattr(cuda_coords, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(cuda_coords, name, counted)

    def notes():
        return [r.note for r in trace.records() if r.name == "gf.eager" and r.note is not None]
    trace.enable()
    yield calls, notes
    trace.disable()


@pytest.mark.parametrize("case", ["Y", "UV", "band", "one_row"])
def test_remap_plane_cuda_gen_route_is_remap_plane(routes, case):
    """A fisheye plane of the 4K shape takes one project_gen call and no
    project call, and gives remap_plane's bits: the whole Y plane, the UV
    plane (source-rect and output-rect maps), a band of rows at an odd
    oy0, a table of one matrix row."""
    calls, notes = routes
    cfg, dyn, mats, img = _uhd_case("UV" if case == "UV" else "Y")
    if case == "one_row":
        mats = mats[:1]
    timg, m = torch.from_numpy(img), torch.from_numpy(mats)
    oh = cfg.out_buffer[1]
    rows, oy0 = (37, 29) if case == "band" else (oh, 0)
    got = tremap.remap_plane_cuda(timg, m, cfg, dyn, out_rows=rows, oy0=oy0)
    assert calls == {"project_gen": 1, "project": 0}
    assert notes() == ["gen"]
    want = tremap.remap_plane(timg, m, cfg, dyn)[oy0:oy0 + rows]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)


def _uhd_ewa_case(plane, ref_jac=False):
    """_uhd_case at interpolation 11 (EWA Robidoux) with its coefficients."""
    cfg, dyn, mats, img = _uhd_case(plane)
    p, q = tremap.ewa_coeffs(11)
    return (cfg._replace(interpolation=11, ewa_ref_jac=ref_jac),
            dyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                         ewa_coeffs_q=np.asarray(q, np.float32)), mats, img)


@pytest.mark.parametrize("case", ["Y", "UV", "band", "one_row", "ref_jac"])
def test_remap_plane_cuda_gen_route_is_remap_plane_ewa(routes, case):
    """A fisheye plane of the 4K shape at EWA 11 takes one project_gen call
    (its three stacked evals) and no project call, inside gf.ewa.stack,
    counts one plane in gf.coords.gen_ewa_planes, and gives remap_plane's
    bits: the whole Y plane, the UV plane, a band of rows at an odd oy0, a
    table of one matrix row, and ewa_ref_jac."""
    calls, notes = routes
    cfg, dyn, mats, img = _uhd_ewa_case("UV" if case == "UV" else "Y", case == "ref_jac")
    if case == "one_row":
        mats = mats[:1]
    timg, m = torch.from_numpy(img), torch.from_numpy(mats)
    oh = cfg.out_buffer[1]
    rows, oy0 = (37, 29) if case == "band" else (oh, 0)
    got = tremap.remap_plane_cuda(timg, m, cfg, dyn, out_rows=rows, oy0=oy0)
    assert calls == {"project_gen": 1, "project": 0}
    assert notes() == ["gen"]
    assert trace.counts()["gf.coords.gen_ewa_planes"] == 1
    assert trace.counts()["gf.coords.points"] == 3 * rows * cfg.out_buffer[0]
    assert [r.name for r in trace.records()].count("gf.ewa.stack") == 1
    want = tremap.remap_plane(timg, m, cfg, dyn)[oy0:oy0 + rows]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)


def _bypass_case(form):
    """(port cfg, port dyn, matrices, image, mesh, remap_plane_cuda keywords)
    of one form that keeps coords_pre."""
    if form == "mesh_fpd":
        cfg, dyn, _, mats, mesh = _mesh_case(fpd=True)
        pcfg, pdyn = tkp.from_reference(cfg, dyn)
        return pcfg, pdyn, mats, make_image(1), np.asarray(mesh, np.float32), {}
    kw = {"lens_correction": dict(lens_correction_amount=0.6),
          "digital_lens": lens_kw("opencv_fisheye", "gopro_superview")}.get(
        form.replace("ewa_", ""), {})
    if form.startswith("ewa"):
        kw["interpolation"] = 11
    _, _, pcfg, pdyn, mats, img = make_case("Y", **kw)
    if form.startswith("ewa"):
        p, q = tremap.ewa_coeffs(11)
        pdyn = pdyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                             ewa_coeffs_q=np.asarray(q, np.float32))
    return pcfg, pdyn, mats, img, None, dict(fused=True) if form == "fused" else {}


@pytest.mark.parametrize("form", ["fisheye", "mesh_fpd", "lens_correction", "digital_lens",
                                  "ewa", "fused", "ewa_lens_correction", "ewa_digital_lens"])
def test_remap_plane_cuda_route_note(routes, form):
    """The first gf.eager span of a plane notes its route, readable from
    trace.records(): "gen" for the plain fisheye, at lanczos4 and at EWA
    (one project_gen call); "pre" for each form that gen_admits refuses,
    at either interpolation, or that takes another kernel (the fused
    launch), which makes no project_gen call. Either way the output is
    remap_plane's."""
    calls, notes = routes
    cfg, dyn, mats, img, mesh, kw = _bypass_case(form)
    if form == "fused":
        assert tremap.use_fused(cfg, torch.from_numpy(mats))
    timg, m = torch.from_numpy(img), torch.from_numpy(mats)
    tmesh = None if mesh is None else torch.from_numpy(mesh)
    got = tremap.remap_plane_cuda(timg, m, cfg, dyn, tmesh, **kw)
    gen = form in ("fisheye", "ewa")
    assert notes() == ["gen" if gen else "pre"]
    assert calls["project_gen"] == int(gen)
    assert (calls["project"] > 0) == (not gen and form != "fused")
    assert cuda_coords.gen_admits(cfg) == (form in ("fisheye", "ewa", "fused"))
    assert torch.equal(got, tremap.remap_plane(timg, m, cfg, dyn, tmesh))


@pytest.mark.parametrize("form", ["fisheye", "mesh_fpd", "lens_correction", "digital_lens",
                                  "ewa", "fused", "ewa_lens_correction", "ewa_digital_lens"])
def test_plane_route(form):
    """plane_route decides each form's route and whether its rolling-shutter
    probe runs on the coords kernel: "gen" for the plain fisheye at lanczos4
    and at EWA, "fused" for fused=True on a plane the fused kernel takes
    ("gen" without it), "pre" for each form gen_admits refuses, with the
    probe for the mesh plane alone, and there only with more than one
    matrix row."""
    cfg, dyn, mats, img, mesh, kw = _bypass_case(form)
    m = torch.from_numpy(mats).repeat(3, 1)      # a rolling-shutter table
    want = {"fisheye": "gen", "ewa": "gen", "fused": "fused"}.get(form, "pre")
    assert tremap.plane_route(cfg, m, None, **kw) == (want, form == "mesh_fpd")
    assert tremap.plane_route(cfg, m).name == ("gen" if form == "fused" else want)
    assert not tremap.plane_route(cfg, m[:1], None, **kw).probe


@pytest.mark.parametrize("form", ["fisheye", "lens_correction"])
def test_projected_positions_freed_before_sampling(monkeypatch, form):
    """On either route nothing holds the projection's raw u, v once
    coords_post_uv has mapped them: the sampler runs with one full-size
    (u, v) pair alive, not two, so a plane's peak memory stays the split
    path's."""
    import weakref
    from gyroflow_torch.ops import cuda_sampler

    raw, dead = [], []
    post_uv, sample = tremap.coords_post_uv, cuda_sampler.sample

    def spy_post_uv(u, v, cfg):
        raw.extend(weakref.ref(t) for t in (u, v))
        return post_uv(u, v, cfg)

    def spy_sample(*a, **k):
        dead.append(all(r() is None for r in raw))
        return sample(*a, **k)
    monkeypatch.setattr(tremap, "coords_post_uv", spy_post_uv)
    monkeypatch.setattr(cuda_sampler, "sample", spy_sample)
    cfg, dyn, mats, img, mesh, kw = _bypass_case(form)
    tremap.remap_plane_cuda(torch.from_numpy(img), torch.from_numpy(mats), cfg, dyn)
    assert len(raw) == 2 and dead == [True]
