"""gyroflow_torch EWA resampling (interpolation 10-13) vs the JAX package, on the CPU.

The same inputs (numpy seeds; cfg/dyn built with the JAX package's
KernelConfig/KernelDynamics and carried over with ``from_reference``) go
through the JAX functions and their port counterparts:

The port runs op by op, in the JAX function's order. JAX under jit fuses
(XLA may contract and reorder float ops), and at ill-conditioned pixels that
moves JAX's own result: a singular Jacobian (background repeat clamps v to
3 px, so dv/dx = dv/dy = 0), a near-singular one (the ellipse's small axis
is a difference of terms ~400x larger), or the stencil at the source edge
where background taps meet content hundreds of codes away. There jit and
eager JAX differ by up to 2.2 codes (measured), while the port stays within
0.04 code of eager JAX. So the op-by-op JAX run is the reference for the
maximum, and the jitted run is held where it is well-conditioned.

- (a) ``remap.sample_ewa`` vs JAX ``remap.sample_ewa`` on the same
  u/v/Jacobian/plane: 0.05 of a code against the eager run; against the
  jitted run on the rows that are not near-singular. The EWA kernel's plain
  version (``cuda_ewa.sample`` on CPU tensors: ``ewa_jacobian`` of the
  stacked evals, then ``sample_ewa``) vs JAX's own Jacobian
  (remap.py:842-845) and eager ``sample_ewa`` on the same evals: 0.05 of a
  code, at the base eval's positions and at other positions (background
  mode 3's second sample); and on evals with inf, NaN and +-1e30 at valid
  pixels, leaving out the pixels whose bbox edge is NaN (``_floor_i32``
  casts that NaN to int32, which torch's CPU cast leaves undefined).
- (b) ``coords_pre(rs_idx=...)`` vs JAX: x/y within 0.05 px, idx passed
  through and the probe skipped.
- (c) ``remap_plane`` vs JAX ``remap_plane`` (eager, maximum) and
  ``remap_plane_jit`` (99th percentile): 0.25 code in the default same-row
  Jacobian mode. The Jacobian multiplies any coordinate difference by
  1/eps = 100, so an ulp in u/v moves it by ~1e-3, which moves a pixel at the
  source edge by up to ~0.2 code. With ``ewa_ref_jac=True`` each eval
  re-probes its row, and a re-probed rint on the other side of a tie picks
  the neighbouring RS row and spikes the Jacobian: 1 code.
- (d) ``remap_plane_cuda`` on CPU tensors (the kernel wrappers run their
  plain versions) vs JAX ``remap_plane_pallas`` (the Pallas EWA kernel in
  interpret mode): 0.25 code, as (c).
- (e) the port vs ``tests/oracle.py`` on the golden EWA cases, with the JAX
  tests' own bounds (test_remap_golden.py TestEWA, TestEWAPallas).
- (f) ``from_reference`` carries the EWA fields.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
import test_remap_golden as golden
from gyroflow_tpu.ops import remap as jremap
from gyroflow_tpu.ops.kernel_params import KernelConfig, KernelDynamics
from gyroflow_torch.ops import cuda_ewa
from gyroflow_torch.ops import kernel_params as tkp
from gyroflow_torch.ops import remap as tremap
from test_torch_remap import H, W, jax_xla, make_case, port_remap
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SAMPLE_TOL = 0.05           # codes, same u/v/jac into both
COORD_TOL_PX = 0.05
F32_TOL = 0.25              # codes, same-row Jacobian
REF_JAC_TOL = 1.0           # codes, ewa_ref_jac=True (row flips)

_jax_sample_ewa = jax.jit(jremap.sample_ewa, static_argnums=(4,))


def with_ewa(cfg, dyn, interpolation, ref_jac=False):
    """cfg/dyn (JAX types) set up for EWA, as the manager's _plane_cfg_dyn does."""
    p, q = jremap.ewa_coeffs(interpolation)
    return (cfg._replace(interpolation=interpolation, ewa_ref_jac=ref_jac),
            dyn._replace(ewa_coeffs_p=np.asarray(p, np.float32),
                         ewa_coeffs_q=np.asarray(q, np.float32)))


def ewa_case(plane="Y", interpolation=11, background_mode=0, ref_jac=False):
    cfg, dyn, _, _, mats, img = make_case(plane, background_mode=background_mode, fov=1.1)
    cfg, dyn = with_ewa(cfg, dyn, interpolation, ref_jac)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    return cfg, dyn, pcfg, pdyn, mats, img


# ---- (a) the sampling twin ----------------------------------------------------

def sample_inputs(c, seed):
    """Noisy 10-bit content and (u, v, jac) that mix magnification, |J| ~ 3
    minification and near-singular Jacobians, with u/v across the plane's
    edges."""
    rng = np.random.default_rng(seed)
    h, w, oh, ow = 40, 56, 24, 32
    img = rng.uniform(0.0, 1023.0, (h, w, c)).astype(np.float32)
    u = rng.uniform(-6.0, w + 6.0, (oh, ow)).astype(np.float32)
    v = rng.uniform(-6.0, h + 6.0, (oh, ow)).astype(np.float32)
    jac = np.asarray([1.0, 0.0, 0.0, 1.0]) + rng.normal(0.0, 0.35, (oh, ow, 4))
    jac[:8] *= 3.0                                     # minification
    a, b = rng.normal(0.0, 1.5, (2, 8, ow))
    t = rng.uniform(-2.0, 2.0, (8, ow))
    jac[8:16] = np.stack([a, b, a * t, b * t], -1) + rng.normal(0.0, 1e-3, (8, ow, 4))
    bg = rng.uniform(0.0, 1023.0, c).astype(np.float32)
    return img, u, v, jac.astype(np.float32), bg, (3, 2, w - 7, h - 5)


@pytest.mark.parametrize("c", [1, 2])
@pytest.mark.parametrize("interpolation", [10, 11, 12, 13])
def test_sample_ewa_vs_jax(interpolation, c):
    img, u, v, jac, bg, rect = sample_inputs(c, seed=interpolation * 10 + c)
    h, w = img.shape[:2]
    p, q = jremap.ewa_coeffs(interpolation)
    p32, q32 = np.asarray(p, np.float32), np.asarray(q, np.float32)
    # interpolation only selects the coefficients, which are dynamic: one
    # compile per channel count
    cfg = KernelConfig(width=w, height=h, output_width=w, output_height=h,
                       interpolation=11, source_rect=rect)
    dyn = KernelDynamics.make(ewa_coeffs_p=p32, ewa_coeffs_q=q32, pixel_value_limit=1000.0)
    jargs = (jnp.asarray(img), jnp.stack([jnp.asarray(u), jnp.asarray(v)], -1),
             jnp.asarray(jac), jnp.asarray(bg), cfg, dyn)
    eager = np.asarray(jremap.sample_ewa(*jargs))
    jitted = np.asarray(_jax_sample_ewa(*jargs))
    t = [torch.from_numpy(a) for a in (img, u, v, jac, bg)]
    got = tremap.sample_ewa(*t[:4], t[4], rect, p32.tolist(), q32.tolist(), 1000.0).numpy()
    assert got.shape == eager.shape == u.shape + (c,)
    assert np.isfinite(got).all()
    assert np.abs(got - eager).max() <= SAMPLE_TOL
    well_conditioned = np.r_[0:8, 16:24]          # rows 8-15 are near-singular
    assert np.abs(got - jitted)[well_conditioned].max() <= SAMPLE_TOL
    # the kernel wrapper runs exactly this plain version on CPU tensors: the
    # Jacobian of the stacked evals, then sample_ewa
    u3, v3, valid3 = (torch.from_numpy(a) for a in _stacked_evals(u, v, jac))
    jac3 = tremap.ewa_jacobian(u3, v3, valid3)[3]
    got3 = tremap.sample_ewa(t[0], t[1], t[2], jac3, t[4], rect, p32.tolist(), q32.tolist(),
                             1000.0).numpy()
    wrapped = cuda_ewa.sample(t[0], t[1], t[2], u3, v3, valid3, tuple(bg.tolist()), rect,
                              (p32.tolist(), q32.tolist()), 1000.0).numpy()
    np.testing.assert_array_equal(wrapped, got3)


def _stacked_evals(u, v, jac, valid3=None):
    """(u3, v3, valid3) numpy (3*oh, ow): the base eval (u, v) and the +eps
    evals whose differences make the Jacobian jac (du/dx, du/dy, dv/dx,
    dv/dy)."""
    eps = np.float32(tremap.EWA_EPS)
    u3 = np.concatenate([u, u + eps * jac[..., 0], u + eps * jac[..., 1]]).astype(np.float32)
    v3 = np.concatenate([v, v + eps * jac[..., 2], v + eps * jac[..., 3]]).astype(np.float32)
    return u3, v3, np.ones(u3.shape, bool) if valid3 is None else valid3


@pytest.mark.parametrize("bad", ["dtype", "jac_shape", "contiguity", "coeffs"])
def test_wrapper_rejects_bad_input(bad):
    """Bad inputs raise: the plane's dtype, the stacked evals' shape (the
    Jacobian's source), a non-contiguous eval, the coefficients."""
    img, u, v, jac, bg, rect = sample_inputs(1, seed=0)
    u3, v3, valid3 = (torch.from_numpy(a) for a in _stacked_evals(u, v, jac))
    img, u, v = (torch.from_numpy(a) for a in (img, u, v))
    coeffs = tuple(tuple(float(x) for x in c) for c in jremap.ewa_coeffs(11))
    exc = ValueError
    if bad == "dtype":
        img, exc = img.to(torch.int32), TypeError
    elif bad == "jac_shape":
        u3 = u3[:-1].contiguous()
    elif bad == "contiguity":
        v3 = v3.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        coeffs = coeffs[:1]
    with pytest.raises(exc):
        cuda_ewa.sample(img, u, v, u3, v3, valid3, (float(bg[0]),), rect, coeffs, 1000.0)


def _jax_ewa_of_evals(img, u, v, u3, v3, valid3, bg, rect, interpolation):
    """JAX: the Jacobian of the stacked evals as remap_plane_pallas forms it
    (remap.py:842-845, op by op), then eager remap.sample_ewa at (u, v);
    pixels whose base eval is not valid get bg."""
    h, w = img.shape[:2]
    oh = u.shape[0]
    eps = 0.01                              # remap.py:772
    uv = jnp.stack([jnp.asarray(u3[:oh]), jnp.asarray(v3[:oh])], -1)
    uv_x = jnp.stack([jnp.asarray(u3[oh:2 * oh]), jnp.asarray(v3[oh:2 * oh])], -1)
    uv_y = jnp.stack([jnp.asarray(u3[2 * oh:]), jnp.asarray(v3[2 * oh:])], -1)
    dx = jnp.where(jnp.asarray(valid3[oh:2 * oh])[..., None], uv_x, 0.0) - uv
    dy = jnp.where(jnp.asarray(valid3[2 * oh:])[..., None], uv_y, 0.0) - uv
    jac = jnp.stack([dx[..., 0] / eps, dy[..., 0] / eps, dx[..., 1] / eps, dy[..., 1] / eps], -1)
    p, q = jremap.ewa_coeffs(interpolation)
    cfg = KernelConfig(width=w, height=h, output_width=w, output_height=h,
                       interpolation=interpolation, source_rect=rect)
    dyn = KernelDynamics.make(ewa_coeffs_p=np.asarray(p, np.float32),
                              ewa_coeffs_q=np.asarray(q, np.float32), pixel_value_limit=1000.0)
    out = jremap.sample_ewa(jnp.asarray(img), jnp.stack([jnp.asarray(u), jnp.asarray(v)], -1),
                            jac, jnp.asarray(bg), cfg, dyn)
    return np.where(valid3[:oh, :, None], np.asarray(out), bg)


def _port_ewa_of_evals(img, u, v, u3, v3, valid3, bg, rect, interpolation):
    coeffs = tuple(tuple(float(x) for x in np.asarray(k, np.float32))
                   for k in jremap.ewa_coeffs(interpolation))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (img, u, v, u3, v3, valid3)]
    return cuda_ewa.sample(*t, tuple(float(b) for b in bg), rect, coeffs, 1000.0).numpy()


@pytest.mark.parametrize("positions", ["base", "feather"])
@pytest.mark.parametrize("c,interpolation", [(1, 11), (2, 13)])
def test_stacked_evals_vs_jax(c, interpolation, positions):
    """The EWA kernel's plain version on stacked evals vs JAX's Jacobian and
    eager sample_ewa: at the base eval's positions, and at background mode
    3's second-sample positions with the base eval's Jacobian. A tenth of
    the +eps evals are not valid, never both of one pixel's: with both
    invalid the Jacobian's columns are equal, f0 = 0, and the ellipse is
    rounding noise of 1e8-sized terms, on which XLA's compiled tap loop and
    torch's op-by-op one differ by tens of codes."""
    img, u, v, jac, bg, rect = sample_inputs(c, seed=40 + c)
    rng = np.random.default_rng(c)
    valid3 = rng.uniform(size=(3 * u.shape[0], u.shape[1])) > 0.1
    oh = u.shape[0]
    valid3[2 * oh:] |= ~valid3[oh:2 * oh]
    u3, v3, valid3 = _stacked_evals(u, v, jac, valid3)
    if positions == "feather":
        h, w = img.shape[:2]
        u = (((u / w - 0.5) * 0.9 + 0.5) * w).astype(np.float32)
        v = (((v / h - 0.5) * 0.9 + 0.5) * h).astype(np.float32)
    got = _port_ewa_of_evals(img, u, v, u3, v3, valid3, bg, rect, interpolation)
    want = _jax_ewa_of_evals(img, u, v, u3, v3, valid3, bg, rect, interpolation)
    assert got.shape == want.shape == u.shape + (c,) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= SAMPLE_TOL


def test_non_finite_evals_vs_jax():
    """inf, -inf, NaN and +-1e30 in the evals of valid pixels (the +eps
    evals' u and v, the base eval, and pairs that make inf - inf): the
    plain version keeps NaN through its clamps as JAX does, and agrees with
    JAX wherever the bbox is defined. Pixels whose bbox edge is NaN are left
    out: remap._floor_i32 casts that NaN to int32, which torch's CPU cast
    leaves undefined."""
    img, u, v, jac, bg, rect = sample_inputs(1, seed=3)
    jac = np.asarray([1.1, 0.0, 0.0, 1.1]) + 0.05 * jac
    u3, v3, valid3 = _stacked_evals(u, v, jac)
    oh = u.shape[0]
    for j, x in enumerate([np.inf, -np.inf, np.nan, 1e30, -1e30]):
        u3[oh + j, :8] = x
        v3[2 * oh + j, 8:16] = x
        u3[2 * oh + j, 16:24] = x
        u3[j + 5, 24:] = x
    u3[oh + 10, :8], u3[2 * oh + 10, :8] = np.inf, -np.inf
    v3[oh + 11, :8], v3[2 * oh + 11, :8] = 1e30, -1e30
    jx, jy, jz, jw = tremap.ewa_jacobian(*(torch.from_numpy(a) for a in (u3, v3, valid3)))[3] \
        .unbind(-1)
    keep = ~(torch.maximum((jx + jy).abs(), (jx - jy).abs()).isnan()
             | torch.maximum((jz + jw).abs(), (jz - jw).abs()).isnan()).numpy()
    assert 0 < int((~keep).sum()) and int(keep.sum()) > keep.size // 2
    got = _port_ewa_of_evals(img, u3[:oh], v3[:oh], u3, v3, valid3, bg, rect, 11)[keep]
    want = _jax_ewa_of_evals(img, u3[:oh], v3[:oh], u3, v3, valid3, bg, rect, 11)[keep]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SAMPLE_TOL


# ---- (b) coords_pre with a given row index ----------------------------------

@pytest.mark.parametrize("lens_correction_amount", [1.0, 0.6])
def test_coords_pre_rs_idx_vs_jax(lens_correction_amount):
    cfg, dyn, pcfg, pdyn, mats, _ = make_case("Y", lens_correction_amount=lens_correction_amount)
    rng = np.random.default_rng(7)
    rs_idx = rng.integers(0, mats.shape[0], (H, W)).astype(np.int32)
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    gx = gx + np.float32(0.01)              # the +eps-in-x eval
    factor = max(np.float32(1.0) - np.float32(lens_correction_amount), np.float32(0.001))
    out_f = tuple(np.float32(f) / np.float32(dyn.fov) / factor for f in dyn.f)
    out_c = (W / 2.0, H / 2.0)

    xj, yj, idxj, probe = jremap.coords_pre(jnp.stack([gx, gy], -1), jnp.asarray(mats), cfg, dyn,
                                            out_c, tuple(jnp.float32(f) for f in out_f),
                                            rs_idx=jnp.asarray(rs_idx))
    assert probe is None
    dt = tkp.dyn_to_torch(pdyn, torch.device("cpu"))
    ti = torch.from_numpy(rs_idx)
    args = (torch.from_numpy(gx), torch.from_numpy(gy))
    tf = tuple(torch.tensor(f) for f in out_f)
    x, y, idx = tremap.coords_pre(*args, torch.from_numpy(mats), pcfg, dt, out_c, tf, rs_idx=ti)
    assert idx is ti and np.array_equal(np.asarray(idxj), rs_idx)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= COORD_TOL_PX
    assert np.abs(y.numpy() - np.asarray(yj)).max() <= COORD_TOL_PX
    # no probe: the matrices are not read at all
    xn, yn, _ = tremap.coords_pre(*args, torch.full((mats.shape[0], 14), float("nan")), pcfg, dt,
                                  out_c, tf, rs_idx=ti)
    assert torch.equal(xn, x) and torch.equal(yn, y)


# ---- (c) remap_plane vs the XLA path ----------------------------------------

@pytest.mark.parametrize("plane,interpolation,bg_mode,ref_jac", [
    ("Y", 10, 0, False), ("Y", 11, 0, False), ("Y", 12, 0, False), ("Y", 13, 0, False),
    ("UV", 11, 0, False), ("Y", 11, 1, False), ("UV", 12, 2, False), ("Y", 13, 3, False),
    ("UV", 11, 3, False), ("Y", 11, 0, True), ("UV", 11, 0, True),
])
def test_remap_plane_vs_xla(plane, interpolation, bg_mode, ref_jac):
    cfg, dyn, pcfg, pdyn, mats, img = ewa_case(plane, interpolation, bg_mode, ref_jac)
    _assert_close_to_jax(port_remap(pcfg, pdyn, mats, img), cfg, dyn, mats, img,
                         REF_JAC_TOL if ref_jac else F32_TOL)


def _assert_close_to_jax(got, cfg, dyn, mats, img, tol):
    eager = np.asarray(jremap.remap_plane(jnp.asarray(img), jnp.asarray(mats), cfg, dyn))
    assert got.shape == eager.shape and np.isfinite(got).all()
    assert np.abs(got - eager).max() <= tol
    assert np.percentile(np.abs(got - jax_xla(cfg, dyn, mats, img)), 99) <= tol


def test_invalid_eps_eval_at_valid_edge():
    """Pixels whose base eval is valid but a +eps eval is not get dx = -uv, a
    Jacobian of ~100x the coordinates: the 10x10 stencil and the f >= 0.1
    floor keep them finite, and the port agrees with JAX there."""
    cfg, dyn, pcfg, pdyn, mats, img = ewa_case("Y", 11)
    # r_limit puts the valid-mask edge within 0.01 px right of / below two
    # pixel centres of this geometry (found by a scan of r_limit)
    dyn = dyn._replace(r_limit=np.float32(0.81))
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    dt = tkp.dyn_to_torch(pdyn, torch.device("cpu"))
    oy, ox = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    factor = torch.clamp_min(1.0 - dt.lens_correction_amount, 0.001)
    out_f = (dt.f[0] / dt.fov / factor, dt.f[1] / dt.fov / factor)
    m = torch.from_numpy(mats)
    x, y, idx = tremap.ewa_stack(ox, oy, m, pcfg, dt, (W / 2.0, H / 2.0), out_f)
    u3, v3, valid3 = tremap.rotate_and_distort(x, y, idx, m, pcfg, dt)
    u3, v3 = tremap.coords_post_uv(u3, v3, pcfg)
    _, _, valid, jac = tremap.ewa_jacobian(u3, v3, valid3)
    edge = valid & ~(valid3[H:2 * H] & valid3[2 * H:])
    assert int(edge.sum()) > 0 and float(jac[edge].abs().max()) > 100.0
    _assert_close_to_jax(port_remap(pcfg, pdyn, mats, img), cfg, dyn, mats, img, F32_TOL)


# ---- (d) the kernel path (plain versions on CPU) vs the Pallas path ----------

def _pallas(cfg, dyn, mats, img):
    out, ov = jremap.remap_plane_pallas_jit(jnp.asarray(img), jnp.asarray(mats), cfg, dyn,
                                            win_h=64, win_w=512)
    assert not bool(ov), "Pallas window overflow at test size"
    return np.asarray(out)


@pytest.mark.parametrize("geometry", ["left_edge_clamp", "rs_rows"])
def test_cuda_path_vs_pallas(geometry):
    if geometry == "left_edge_clamp":
        # test_remap_golden.py:277-298: border pixels whose stencil starts left
        # of / above the plane
        img = golden.make_image()
        cfg, dyn, _, mats = golden.make_pair()
        cfg, dyn = with_ewa(cfg, dyn, 11)
        pcfg, pdyn = tkp.from_reference(cfg, dyn)
    else:
        cfg, dyn, pcfg, pdyn, mats, img = ewa_case("Y", 11)
    want = _pallas(cfg, dyn, mats, img)
    got = port_remap(pcfg, pdyn, mats, img, cuda_path=True)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL


# ---- (e) the golden EWA cases against the scalar oracle ----------------------

def _golden(interpolation, background_mode=0, fov=0.9, rotations=None, ref_jac=False):
    img = golden.make_image()
    cfg, dyn, p, mats = golden.make_pair(background_mode=background_mode, fov=fov,
                                         rotations=rotations)
    cfg, dyn = with_ewa(cfg, dyn, interpolation, ref_jac)
    pq, qq = jremap.ewa_coeffs(interpolation)
    p.update(interpolation=interpolation, ewa_coeffs_p=list(pq), ewa_coeffs_q=list(qq),
             ewa_ref_jac=ref_jac)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    got = tremap.remap_plane(torch.from_numpy(img), torch.from_numpy(mats), pcfg, pdyn).numpy()
    return got, oracle.undistort_image(img, p, mats)


_RS_ROTATIONS = [(0.02 + 0.002 * i, -0.03 + 0.0015 * i, 0.01 - 0.001 * i)
                 for i in range(golden.H)]


@pytest.mark.parametrize("interpolation", [10, 11, 12, 13])
def test_oracle_ewa_modes(interpolation):
    got, want = _golden(interpolation)
    assert np.abs(got - want).max() < 1.0            # test_remap_golden.py:235


def test_oracle_feather_mode():
    got, want = _golden(13, background_mode=3, fov=1.2)
    assert np.abs(got - want).max() < 1.5            # test_remap_golden.py:248


@pytest.mark.parametrize("ref_jac", [False, True])
def test_oracle_rs_jacobian_modes(ref_jac):
    got, want = _golden(11, rotations=_RS_ROTATIONS, ref_jac=ref_jac)
    d = np.abs(got - want)
    if ref_jac:
        assert np.percentile(d, 99) < 2.0            # test_remap_golden.py:357
    else:
        assert d.max() < 1.5                         # test_remap_golden.py:346


# ---- (f) the EWA fields survive from_reference -------------------------------

def test_from_reference_carries_ewa_fields():
    cfg, dyn, pcfg, pdyn, _, _ = ewa_case("UV", 13, ref_jac=True)
    assert pcfg.ewa_ref_jac is True and pcfg == cfg
    p, q = jremap.ewa_coeffs(13)
    np.testing.assert_array_equal(pdyn.ewa_coeffs_p, np.asarray(p, np.float32))
    np.testing.assert_array_equal(pdyn.ewa_coeffs_q, np.asarray(q, np.float32))
    assert tremap._ewa_coeffs_of(pdyn) == tuple(
        tuple(float(x) for x in np.asarray(c, np.float32)) for c in (p, q))
