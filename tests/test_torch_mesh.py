"""Sony mesh correction and focal-plane distortion in gyroflow_torch, on the CPU.

The port's counterpart of test_mesh.py and of test_sony_canon.py's kernel
flow. The same seeded inputs go through the JAX package and the port:

- the splines (the port's copy of core/splines.py) and the torch mesh stage
  (ops/mesh.py) against the float64 host splines and the JAX mesh stage;
- remap_plane with mesh and mesh + FPD against ``remap_plane_jit`` (XLA) and
  ``remap_plane_pallas`` (the Pallas sampler in interpret mode, as
  TestMeshPallas runs it) and against ``tests/oracle.py``;
- a Sony clip (the tag-map fixture of test_sony_canon.py, both carriages)
  through the port's manager on ``device="cpu"`` against the JAX manager:
  process_pixels, process_pixels_window and the ST maps.

Tolerances: 0.25 of a code in float32 against the JAX remap (the port's
plain path runs the JAX float32 ops in the same order; the Pallas sampler's
phase quantisation adds its own rounding), 1 code after the uint16 cast (a
float difference of ~1e-4 can cross a rounding boundary), < 1.0 against the
float64 oracle (test_mesh.py's bound), 1e-5 on the normalised ST maps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_tpu.core.telemetry import sony as jsony
from gyroflow_tpu.ops import mesh as jmesh
from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import (FRAMEBUFFER_INVERTED, HAS_FPD_DATA, HAS_IBIS_DATA,
                                            HAS_MESH_DATA)
from gyroflow_tpu.parallel.pipeline import make_frame_mesh as jax_frame_mesh
from gyroflow_tpu.utils import stmap as jstmap
from gyroflow_torch.core import splines as tsplines
from gyroflow_torch.core.manager import StabilizationManager
from gyroflow_torch.ops import cuda_coords, kernel_params as tkp, mesh as tmesh
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.parallel.pipeline import stack_meshes
from gyroflow_torch.utils import stmap

from test_mesh import make_mesh
from test_remap_golden import H, W, make_image, make_pair
from test_sony_canon import FPS, N_FRAMES, W as SW, H as SH, make_tagmap
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

F32_TOL = 0.25        # codes, float32 output
U16_TOL = 1           # codes, uint16 output
ORACLE_TOL = 1.0      # test_mesh.py's golden bound
STMAP_TOL = 1e-5      # normalised ST-map coordinates
# per-row rolling-shutter rotations, so the row select (and the mesh frame's
# probe) matters
RS_ROTATIONS = [(0.02 + 0.0008 * i, -0.03 + 0.0003 * i, 0.01) for i in range(H)]


def _mesh_case(fpd, ibis=False, inverted=False, rotations=None):
    """(JAX cfg, JAX dyn, oracle params, matrices, mesh f64) of test_mesh.py's
    geometry with its seeded 9x9 mesh (and FPD shears)."""
    cfg, dyn, p, mats = make_pair(rotations=rotations)
    mats = np.asarray(mats, np.float32)
    if ibis:
        mats[:, 9:14] = [0.4, -0.3, 0.002, 0.1, 0.05]
    flags = cfg.flags | HAS_MESH_DATA | (HAS_FPD_DATA if fpd else 0)
    flags |= (HAS_IBIS_DATA if ibis else 0) | (FRAMEBUFFER_INVERTED if inverted else 0)
    cfg = cfg._replace(flags=flags, mesh_grid=(9, 9))
    p.update(flags=flags)
    return cfg, dyn, p, mats, make_mesh(fpd=fpd)


def _port(cfg, dyn, mats, img, mesh, cuda_path=False, out_dtype="f32"):
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    fn = tremap.remap_plane_cuda if cuda_path else tremap.remap_plane
    return fn(torch.from_numpy(img), torch.from_numpy(mats), pcfg, pdyn,
              torch.from_numpy(np.asarray(mesh, np.float32)), out_dtype=out_dtype).numpy()


class TestSplines:
    def test_catmull_rom_hits_points(self):
        cr = tsplines.CatmullRom([0.0, 1.0, 2.0, 3.0], [[0.0], [1.0], [4.0], [9.0]])
        for t, v in [(1.0, 1.0), (2.0, 4.0)]:
            assert abs(cr.interpolate(t)[0, 0] - v) < 1e-9

    def test_catmull_rom_outside_zero(self):
        cr = tsplines.CatmullRom([0.0, 1.0], [[1.0], [2.0]])
        assert cr.interpolate(5.0)[0, 0] == 0.0

    def test_bivariate_identity_grid(self):
        """An identity grid maps points to themselves: the host splines
        exactly, the torch mesh stage within float32 rounding."""
        gx, gy = np.meshgrid(np.linspace(0, W, 9), np.linspace(0, H, 9))
        mesh_id = tsplines.build_mesh_buffer(np.stack([gx, gy], -1), (float(W), float(H)))
        xs, ys = np.array([10.0, 30.0, 55.0]), np.array([5.0, 20.0, 44.0])
        out = tsplines.interpolate_mesh(xs, ys, (float(W), float(H)), mesh_id)
        np.testing.assert_allclose(out[:, 0], xs, atol=1e-6)
        np.testing.assert_allclose(out[:, 1], ys, atol=1e-6)
        cfg = tkp.KernelConfig(width=W, height=H, output_width=W, output_height=H,
                               flags=HAS_MESH_DATA, mesh_grid=(9, 9))
        u, v = tmesh.apply_mesh_correction(torch.tensor(xs, dtype=torch.float32),
                                           torch.tensor(ys, dtype=torch.float32),
                                           torch.from_numpy(mesh_id.astype(np.float32)), cfg)
        np.testing.assert_allclose(u.numpy(), xs, atol=1e-4)
        np.testing.assert_allclose(v.numpy(), ys, atol=1e-4)

    @pytest.mark.parametrize("grid", [(9, 9), (5, 4), (2, 3)])
    def test_bivariate_matches_host_and_jax(self, grid):
        """The torch bivariate spline against the float64 host splines (1e-3
        px) and the JAX mesh stage (1e-4 px), inside and beyond the grid
        (the linear extrapolation), on a seeded warped grid."""
        gw, gh = grid
        rng = np.random.default_rng(gw * 10 + gh)
        size = (120.0, 80.0)
        gx, gy = np.meshgrid(np.linspace(0, size[0], gw), np.linspace(0, size[1], gh))
        pts = np.stack([gx + rng.normal(0, 1.5, gx.shape), gy + rng.normal(0, 1.5, gy.shape)], -1)
        mesh = tsplines.build_mesh_buffer(pts, size)
        xs = rng.uniform(-10.0, size[0] + 10.0, 200)
        ys = rng.uniform(-10.0, size[1] + 10.0, 200)
        want = tsplines.interpolate_mesh(xs, ys, size, mesh)
        m32 = mesh.astype(np.float32)
        for ch in (0, 1):
            got = tmesh._bivariate(torch.from_numpy(m32), ch, torch.tensor(xs, dtype=torch.float32),
                                   torch.tensor(ys, dtype=torch.float32),
                                   torch.tensor(size[0]), torch.tensor(size[1]), gw, gh).numpy()
            jax = np.asarray(jmesh._bivariate(jnp.asarray(m32), ch, jnp.asarray(xs, jnp.float32),
                                              jnp.asarray(ys, jnp.float32), jnp.float32(size[0]),
                                              jnp.float32(size[1]), gw, gh))
            assert np.abs(got - want[:, ch]).max() < 1e-3
            assert np.abs(got - jax).max() < 1e-4

    def test_spline_mus_are_the_plain_recurrence(self):
        """The coords kernel takes the recurrence's mus from the host: the
        same float32 values as _solve_spline's per-pixel mus."""
        for n in range(2, 10):
            vals = [torch.zeros(3) for _ in range(n)]
            zero = torch.zeros(3)
            mus = [zero] * n
            for i in range(1, n - 1):
                mus[i] = 1.0 / (4.0 - mus[i - 1])
            host = tmesh.spline_mus(n)
            assert len(host) == 9 and host[0] == 0.0
            for i in range(n):
                assert np.float32(mus[i][0]) == host[i]
            tmesh._solve_spline(vals, torch.tensor(10.0), n)

    def test_mesh_args_layout(self):
        cfg, dyn, _, mats, mesh = _mesh_case(fpd=True)
        pcfg, _ = tkp.from_reference(cfg, dyn)
        t = torch.from_numpy(mesh.astype(np.float32))
        a = cuda_coords.mesh_args(pcfg, t)
        assert a.data == t.data_ptr() and (a.gw, a.gh) == (9, 9)
        assert int(mesh[0]) == tmesh.fpd_offset(pcfg)
        assert a.block_offset == cuda_coords.mesh_block_offset(pcfg) \
            >= tmesh.fpd_offset(pcfg) + 24 and a.block_offset % 4 == 0
        assert list(a.mus) == [float(m) for m in tmesh.spline_mus(9)]
        assert a.inv_gw1 == float(np.float32(1.0) / np.float32(8.0))
        assert a.inv_width == float(np.float32(1.0) / np.float32(W))
        assert cuda_coords.mesh_args(pcfg._replace(flags=0, mesh_grid=None), None).data is None


def _packed_case(gw, gh, inverted=False, seed=0):
    """(port cfg, reference mesh buffer f32) of a gw x gh warped grid with
    FPD shears, a mesh size, origin and crop that are not integers."""
    rng = np.random.default_rng(seed * 100 + gw * 10 + gh)
    size = (W * 1.03, H * 0.97)
    gx, gy = np.meshgrid(np.linspace(0, size[0], gw), np.linspace(0, size[1], gh))
    pts = np.stack([gx + rng.normal(0, 1.5, gx.shape), gy + rng.normal(0, 1.5, gy.shape)], -1)
    ref = tsplines.build_mesh_buffer(pts, size, origin=(2.5, -1.75),
                                     crop_size=(W * 0.99, H * 1.01),
                                     focal_plane_shears=rng.normal(0, 0.01, (8, 2)),
                                     fpd_enabled=True).astype(np.float32)
    cfg = tkp.KernelConfig(width=W, height=H, output_width=W, output_height=H,
                           flags=HAS_MESH_DATA | HAS_FPD_DATA
                           | (FRAMEBUFFER_INVERTED if inverted else 0), mesh_grid=(gw, gh))
    return cfg, ref


def _block_matches_reference(packed, ref, cfg):
    """The packed buffer: the reference part as given (zeros to the block),
    the constants, the FPD shears, and each (channel, x segment, grid row)
    as the reference's (a, b, c, d) of that row and segment."""
    gw, gh = cfg.mesh_grid
    off = cuda_coords.mesh_block_offset(cfg)
    assert packed.dtype == np.float32 and packed.size == cuda_coords.packed_len(cfg)
    assert off % 4 == 0 and packed.size % 4 == 0
    np.testing.assert_array_equal(packed[:ref.size], ref)
    assert not packed[ref.size:off].any()
    np.testing.assert_array_equal(packed[off:off + 12], cuda_coords.mesh_consts(ref, cfg))
    o = tmesh.fpd_offset(cfg)
    np.testing.assert_array_equal(packed[off + 12:off + 28], ref[o + 4:o + 20])
    rows = packed[off + 28:].reshape(2, gw - 1, gh, 4)
    base = 9 + gw * gh * 2
    for c in range(2):
        for fi in range(gw - 1):
            for j in range(gh):
                rb = base + c * gh * 36 + j * 36 + fi
                assert rows[c, fi, j].tolist() == [ref[rb + q * 9] for q in range(4)], (c, fi, j)


class _CardDivision(torch.overrides.TorchFunctionMode):
    """Runs torch ops as the card runs them where the CPU differs: a tensor
    divided by a Python number is multiplied by the number's float32
    reciprocal (the CPU divides). Keeps the bits of every 0-d result."""

    def __init__(self):
        super().__init__()
        self.bits = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.__truediv__, torch.Tensor.div, torch.div) and len(args) == 2 \
                and isinstance(args[1], (int, float)) and not kwargs:
            out = args[0] * (torch.tensor(1.0) / torch.tensor(float(args[1])))
        else:
            out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and out.dim() == 0 and out.dtype == torch.float32:
            self.bits.add(int(out.view(torch.int32)))
        return out


@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("gh", range(2, 10))
def test_mesh_consts_are_the_plain_stages_values(gh, inverted):
    """The packed block's launch-uniform constants, computed on the host in
    numpy float32, are bit-equal to the 0-d values ops/mesh.py computes in
    torch on the CPU (its header entries, the crop spans, the FPD band, the
    spline's h, 1 / h, 3 * (1 / h), h / 3 and 3 * h), each division by a
    Python number taken as torch takes it on the card, where the kernel's
    plain version runs: torch on the CPU divides, the card multiplies by
    the float32 reciprocal."""
    cfg, ref = _packed_case(11 - gh, gh, inverted)
    k = cuda_coords.mesh_consts(ref, cfg)
    np.testing.assert_array_equal(k[:4], ref[3:7])
    rec = _CardDivision()
    u = torch.tensor([3.5, 60.25, 200.0, -7.0])
    v = torch.tensor([1.25, 33.5, -4.0, 90.0])
    mesh = torch.from_numpy(ref)
    with rec:
        tmesh.apply_mesh_correction(u, v, mesh, cfg)
        tmesh.apply_focal_plane_distortion(u, v, mesh, tmesh.fpd_offset(cfg), cfg)
    names = ["span_x", "span_y", "band", "h", "inv_h", "alpha_h", "h_3", "three_h"]
    for name, val in zip(names, k[4:]):
        if name == "alpha_h" and gh == 2:     # no interior row: mesh.py computes no alpha
            continue
        assert int(np.float32(val).view(np.int32)) in rec.bits, (name, val)


@pytest.mark.parametrize("gw,gh", [(9, 9), (5, 4), (2, 3), (3, 2)])
def test_pack_mesh_block_holds_the_reference(gw, gh):
    """pack_mesh's block holds exactly the reference buffer's coefficients,
    and a packed buffer goes through pack_mesh again unchanged."""
    cfg, ref = _packed_case(gw, gh)
    packed = cuda_coords.pack_mesh(ref, cfg)
    _block_matches_reference(packed, ref, cfg)
    np.testing.assert_array_equal(cuda_coords.pack_mesh(packed, cfg), packed)
    np.testing.assert_array_equal(cuda_coords.pack_mesh(torch.from_numpy(ref), cfg), packed)


def test_packed_buffers_through_the_manager(sony_managers, monkeypatch):
    """The buffers the manager puts on its device: _mats_on_device's (one
    frame) and the window's stack (stack_meshes of each frame's packed
    buffer, caught where the window step takes it), each row the frame's
    reference buffer with its block."""
    from gyroflow_torch.parallel import pipeline
    tm, _ = sony_managers
    seen = []
    orig = pipeline.stabilize_window_production

    def spy(*a, meshes=None, **kw):
        seen.append(meshes)
        return orig(*a, meshes=meshes, **kw)

    monkeypatch.setattr(pipeline, "stabilize_window_production", spy)
    tm.process_pixels_window(TS[:2], _sony_plane(n=2), None, interpolation=2,
                             max_pixel_value=1023.0)
    (stack,) = seen
    assert stack.shape[0] == 2
    for i, ts in enumerate(TS[:2]):
        ft = tm.frame_transform_at(tm._adjusted_ts_ms(ts))
        _block_matches_reference(stack[i], ft.mesh_data, ft.kernel_cfg)
        _, mesh = tm._mats_on_device(tm._adjusted_ts_ms(ts), ft)
        _block_matches_reference(mesh.numpy(), ft.mesh_data, ft.kernel_cfg)


def test_coords_wrapper_refuses_unpacked_or_misaligned_mesh():
    """cuda_coords.project takes only a packed buffer that starts on 16
    bytes (the kernel reads the block as float4s), on the CPU too; the
    remap wrapper packs a host buffer itself."""
    cfg, dyn, _, mats, mesh = _mesh_case(fpd=True)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    ref = mesh.astype(np.float32)
    x = torch.full((4, 8), 30.0)
    y = torch.full((4, 8), 20.0)
    idx = torch.zeros((4, 8), dtype=torch.int32)
    m = torch.from_numpy(mats)
    with pytest.raises(ValueError, match="pack_mesh"):
        cuda_coords.project(x, y, idx, m, pcfg, pdyn, torch.from_numpy(ref))
    packed = cuda_coords.pack_mesh(ref, pcfg)
    shifted = torch.zeros(packed.size + 1)[1:]
    shifted.copy_(torch.from_numpy(packed))
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_coords.project(x, y, idx, m, pcfg, pdyn, shifted)
    with pytest.raises(ValueError, match="needs"):
        cuda_coords.pack_mesh(ref[:100], pcfg)
    got = cuda_coords.project(x, y, idx, m, pcfg, pdyn, torch.from_numpy(packed))
    want = cuda_coords.project_plain(x, y, idx, m, pcfg, pdyn, torch.from_numpy(ref))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("interpolation", [8, 11])
def test_remap_wrapper_takes_reference_or_packed_buffers(interpolation):
    """remap_plane_cuda takes the frame's mesh buffer as the JAX remap does,
    in the reference layout (a tensor or numpy) or packed, and packs a host
    buffer itself: each gives the plain path's bits (on a card:
    test_torch_cuda.py)."""
    cfg, dyn, _, mats, mesh = _mesh_case(fpd=True, ibis=True)
    cfg = cfg._replace(interpolation=interpolation)
    if interpolation > 8:
        p, q = jremap.ewa_coeffs(interpolation)
        dyn = dyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                           ewa_coeffs_q=np.asarray(q, np.float32))
    pcfg, pdyn = tkp.from_reference(cfg, dyn._replace(max_pixel_value=np.float32(1023.0),
                                                      pixel_value_limit=np.float32(1023.0)))
    ref = np.asarray(mesh, np.float32)
    img = torch.from_numpy(np.rint(make_image() * 4.0).astype(np.uint16))
    m = torch.from_numpy(mats)
    want = tremap.remap_plane(img, m, pcfg, pdyn, torch.from_numpy(ref), out_dtype="uint16")
    for buf in (torch.from_numpy(ref), ref, torch.from_numpy(cuda_coords.pack_mesh(ref, pcfg))):
        got = tremap.remap_plane_cuda(img, m, pcfg, pdyn, buf, out_dtype="uint16")
        assert torch.equal(got, want)


def test_buffer_off_the_host_not_packed_is_refused():
    """A mesh buffer that is not on the host and not packed is refused, never
    downloaded to be packed: pack_mesh takes host buffers only, and
    remap_plane_cuda names pack_mesh (a meta tensor stands for the card's)."""
    cfg, dyn, _, mats, mesh = _mesh_case(fpd=True)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    off_host = torch.from_numpy(np.asarray(mesh, np.float32)).to("meta")
    with pytest.raises(ValueError, match="host buffer"):
        cuda_coords.pack_mesh(off_host, pcfg)
    img = torch.from_numpy(np.rint(make_image() * 4.0).astype(np.uint16))
    with pytest.raises(ValueError, match="pack_mesh"):
        tremap.remap_plane_cuda(img, torch.from_numpy(mats), pcfg, pdyn, off_host)


class TestMeshGolden:
    @pytest.mark.parametrize("fpd", [False, True])
    def test_oracle_golden(self, fpd):
        img = make_image()
        cfg, dyn, p, mats, mesh = _mesh_case(fpd)
        want = oracle.undistort_image(img, p, mats, mesh)
        for cuda_path in (False, True):
            got = _port(cfg, dyn, mats, img, mesh, cuda_path)
            assert np.abs(got - want).max() < ORACLE_TOL, (cuda_path, np.abs(got - want).max())

    def test_mesh_changes_output(self):
        img = make_image()
        cfg, dyn, _, mats = make_pair()
        mats = np.asarray(mats, np.float32)
        pcfg, pdyn = tkp.from_reference(cfg, dyn)
        base = tremap.remap_plane(torch.from_numpy(img), torch.from_numpy(mats), pcfg,
                                  pdyn).numpy()
        gx, gy = np.meshgrid(np.linspace(0, W, 9), np.linspace(0, H, 9))
        mesh = tsplines.build_mesh_buffer(np.stack([gx + 2.0, gy], axis=-1), (float(W), float(H)))
        shifted = _port(cfg._replace(flags=cfg.flags | HAS_MESH_DATA, mesh_grid=(9, 9)), dyn,
                        mats, img, mesh)
        assert np.abs(shifted - base).max() > 1.0


class TestMeshVsJax:
    @pytest.mark.parametrize("case", ["mesh", "mesh+fpd", "mesh+fpd+ibis", "inverted",
                                      "fpd only"])
    def test_matches_xla(self, case):
        """Per-row RS matrices, so coords_pre's probe runs the mesh stage;
        the plain path and the kernel path (wrappers' plain versions on the
        CPU, the probe through cuda_coords.project) against remap_plane_jit."""
        img = make_image()
        cfg, dyn, _, mats, mesh = _mesh_case(fpd=case != "mesh", ibis="ibis" in case,
                                             inverted=case == "inverted",
                                             rotations=RS_ROTATIONS)
        if case == "fpd only":
            cfg = cfg._replace(flags=cfg.flags & ~HAS_MESH_DATA)
        want = np.asarray(jremap.remap_plane_jit(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                                 jnp.asarray(mesh, jnp.float32)))
        plain = _port(cfg, dyn, mats, img, mesh)
        assert np.abs(plain - want).max() <= F32_TOL
        assert np.array_equal(_port(cfg, dyn, mats, img, mesh, cuda_path=True), plain)

    @pytest.mark.parametrize("fpd", [False, True])
    def test_matches_pallas(self, fpd):
        """Against remap_plane_pallas (interpret mode), which computes the
        mesh coords in XLA and samples with the Pallas kernel."""
        img = make_image()
        cfg, dyn, _, mats, mesh = _mesh_case(fpd, rotations=RS_ROTATIONS)
        pal, ov = jremap.remap_plane_pallas(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                            jnp.asarray(mesh, jnp.float32), win_h=64, win_w=512)
        assert not bool(ov)
        got = _port(cfg, dyn, mats, img, mesh, cuda_path=True)
        assert np.abs(got - np.asarray(pal)).max() <= F32_TOL

    def test_ewa_with_mesh(self):
        """EWA (interpolation 11): the stacked evals carry the mesh, the +eps
        evals on the base row (remap.py:830-840)."""
        img = make_image()
        cfg, dyn, _, mats, mesh = _mesh_case(True, rotations=RS_ROTATIONS)
        cfg = cfg._replace(interpolation=11)
        p, q = jremap.ewa_coeffs(11)
        dyn = dyn._replace(ewa_coeffs_p=jnp.asarray(p, jnp.float32),
                           ewa_coeffs_q=jnp.asarray(q, jnp.float32))
        want = np.asarray(jremap.remap_plane_jit(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                                 jnp.asarray(mesh, jnp.float32)))
        got = _port(cfg, dyn, mats, img, mesh, cuda_path=True)
        assert np.abs(got - want).max() <= F32_TOL
        assert np.array_equal(_port(cfg, dyn, mats, img, mesh), got)

    def test_mesh_buffer_checks(self):
        img = make_image()
        cfg, dyn, _, mats, mesh = _mesh_case(True)
        pcfg, pdyn = tkp.from_reference(cfg, dyn)
        args = (torch.from_numpy(img), torch.from_numpy(mats))
        with pytest.raises(ValueError, match="no mesh buffer"):
            tremap.remap_plane(*args, pcfg, pdyn)
        with pytest.raises(ValueError, match="needs"):
            tremap.remap_plane(*args, pcfg, pdyn, torch.zeros(100))
        with pytest.raises(ValueError, match="mesh_grid"):
            tremap.remap_plane(*args, pcfg._replace(mesh_grid=None), pdyn, torch.zeros(2000))
        # without the flags the buffer is not read, as in the JAX remap
        plain = tremap.remap_plane(*args, pcfg._replace(flags=0), pdyn, torch.zeros(4))
        assert plain.shape == (H, W, 1)


# ---- a Sony clip through the managers --------------------------------------

@pytest.fixture(scope="module", params=["cbor", "klv"])
def sony_managers(request, tmp_path_factory):
    """The port's manager on the CPU and the JAX manager, each loading the
    same synthetic Sony clip (IBIS, a 5x4 mesh and FPD on every frame)."""
    path = str(tmp_path_factory.mktemp("sony") / f"sony_{request.param}.mp4")
    with open(path, "wb") as f:
        f.write(jsony.build_tagmap_mp4([make_tagmap(i) for i in range(N_FRAMES)], FPS,
                                       encoding=request.param))
    out = []
    for m in (StabilizationManager(device="cpu"), JManager()):
        m.init_from_video_data(N_FRAMES / FPS * 1000.0, FPS, N_FRAMES, (SW, SH))
        m.load_gyro_data(path)
        m.recompute_blocking()
        out.append(m)
    return out


def _sony_plane(seed=0, n=None):
    """Smooth 10-bit content (test_sony_canon.py's golden image, scaled),
    n frames each shifted a little, or one frame."""
    gx, gy = np.meshgrid(np.arange(SW), np.arange(SH))
    frames = [(500.0 + 320.0 * np.sin((gx + 3 * i) * 0.05) * np.cos(gy * 0.07) + 0.8 * gx)
              for i in range(n or 1)]
    out = np.rint(np.stack(frames)[..., None]).astype(np.uint16)
    return out if n else out[0]


TS = [int(round(k * 1e6 / FPS)) for k in (2, 3, 4, 5)]


def test_sony_flow_matches_jax(sony_managers):
    """test_ibis_mesh_flow_golden through the managers: IBIS + mesh + FPD
    from the parsed metadata, process_pixels in uint16."""
    tm, jm = sony_managers
    ft = tm.frame_transform_at(TS[0] / 1000.0)
    cfg = ft.kernel_cfg
    assert cfg.has(HAS_IBIS_DATA) and cfg.has(HAS_MESH_DATA) and cfg.has(HAS_FPD_DATA)
    assert cfg.mesh_grid == (5, 4)
    np.testing.assert_array_equal(ft.mesh_data, jm.frame_transform_at(TS[0] / 1000.0).mesh_data)
    img = _sony_plane()
    for interpolation in (2, 8):
        got, info = tm.process_pixels(TS[0], img, interpolation=interpolation,
                                      max_pixel_value=1023.0)
        want, _ = jm.process_pixels(TS[0], img, interpolation=interpolation,
                                    max_pixel_value=1023.0, use_pallas=False)
        assert info["backend"] == "torch-cpu" and got.dtype == torch.uint16
        d = np.abs(got.numpy().astype(np.int64) - np.asarray(want).astype(np.int64)).max()
        assert d <= U16_TOL, (interpolation, d)


def test_sony_window_matches_jax(sony_managers):
    """process_pixels_window over 4 Sony frames: each frame's own mesh
    buffer, against the JAX window (XLA path) and the port's per-frame
    process_pixels."""
    tm, jm = sony_managers
    frames = _sony_plane(n=len(TS))
    got, info = tm.process_pixels_window(TS, frames, None, interpolation=8,
                                         max_pixel_value=1023.0)
    want, _ = jm.process_pixels_window(TS, frames, jax_frame_mesh(1), interpolation=8,
                                       max_pixel_value=1023.0, use_pallas=False)
    assert info["backend"] == "torch-cpu-window" and got.dtype == torch.uint16
    assert np.abs(got.numpy().astype(np.int64) - np.asarray(want).astype(np.int64)).max() \
        <= U16_TOL
    for i, ts in enumerate(TS):
        one, _ = tm.process_pixels(ts, frames[i], interpolation=8, max_pixel_value=1023.0)
        assert torch.equal(got[i], one)


def test_stack_meshes():
    a, b = np.arange(5, dtype=np.float32), np.arange(3, dtype=np.float32)
    out = stack_meshes([a, b])
    assert out.shape == (2, 5) and out.dtype == np.float32
    np.testing.assert_array_equal(out[1], [0, 1, 2, 0, 0])
    assert stack_meshes([None, None]) is None
    with pytest.raises(ValueError, match="mixes"):
        stack_meshes([a, None])


def test_sony_stmaps_match_jax(sony_managers):
    """ST-map export of a Sony frame: the undistort map carries the mesh
    (stmap.py:102-105), the redistort map runs the host points path
    (undistort_points, FPD with sign +1)."""
    tm, jm = sony_managers
    for ts, frame in ((100.0, 3), (200.0, 6)):
        ox, oy, mats, cfg, dyn, out_c, out_f, mesh = stmap.undistort_inputs(tm, ts, True, frame)
        assert mesh is not None and cfg.has(HAS_MESH_DATA) and cfg.has(HAS_FPD_DATA)
        got = stmap.compute_undistort_stmap(tm, ts, True, frame)
        want = jstmap.compute_undistort_stmap(jm, ts, True, frame)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= STMAP_TOL
        red = stmap.compute_redistort_stmap(tm, ts, True, frame)
        jred = jstmap.compute_redistort_stmap(jm, ts, True, frame)
        assert red.shape == (SH, SW, 3) and np.abs(red - jred).max() <= STMAP_TOL


def test_cli_renders_a_sony_clip_with_its_mesh(tmp_path):
    """The CLI on a y4m with a Sony MP4 as its gyro file (chip_smoke.py
    phase 9's tag maps, 160x96, a 5x4 mesh): 8 frames out, and the clip's
    mesh and FPD change them (the same clip without those tags renders
    otherwise)."""
    import json
    from chip_smoke import sony_tagmap
    from gyroflow_torch import cli
    from gyroflow_torch.core.telemetry import sony as tsony
    from gyroflow_torch.render.y4m_io import Y4MReader, Y4MWriter

    w, h, n = 160, 96, 8
    rng = np.random.default_rng(0)
    clip = tmp_path / "clip.y4m"
    wr = Y4MWriter(str(clip), w, h, 30.0, "yuv420p10le")
    for _ in range(n):
        wr.write_planes([rng.integers(0, 1024, (h, w, 1)).astype(np.uint16),
                         rng.integers(0, 1024, (h // 2, w // 2, 1)).astype(np.uint16),
                         rng.integers(0, 1024, (h // 2, w // 2, 1)).astype(np.uint16)])
    wr.close()
    outs = {}
    for mesh in (True, False):
        maps = [sony_tagmap(i, w, h, 5) for i in range(n)]
        if not mesh:
            for tm in maps:
                del tm["mesh_correction"], tm["focal_plane_distortion"]
        mp4 = tmp_path / f"sony_{mesh}.mp4"
        mp4.write_bytes(tsony.build_tagmap_mp4(maps, 30.0, encoding="klv"))
        lens = tmp_path / "lens.json"
        lens.write_text(json.dumps(tsony.parse_sony_mp4(str(mp4), 30.0, (w, h)).lens_profile))
        assert cli.main([str(clip), "-g", str(mp4), str(lens), "-f", "--device", "cpu"]) == 0
        outs[mesh] = [p[0].copy() for _, p in Y4MReader(str(tmp_path / "clip_stabilized.y4m"))]
    assert len(outs[True]) == len(outs[False]) == n
    assert any(not np.array_equal(a, b) for a, b in zip(outs[True], outs[False]))
