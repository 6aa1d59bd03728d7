"""gyroflow_torch lens models vs the JAX package's, on the CPU.

Same points (numpy seed) through ``gyroflow_tpu.ops.distortion_models`` and
``gyroflow_torch.ops.distortion_models``, for every one of the 14 models,
with the coefficient shapes of ``tests/test_distortion_models.py``.
Tolerances: 1e-5 in normalised coordinates (the same float32 ops; XLA and
torch may round tan/sqrt a few ulp apart). An undistort's result can grow
without bound (tan(theta) near theta = pi/2), so there the limit is 1e-5 of
the coordinate's magnitude. The digital lenses work in pixels: 0.05 px.
``valid`` must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import distortion_models as jdm
from gyroflow_torch.ops import distortion_models as tdm
from test_distortion_models import make_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
DIGITAL_TOL_PX = 0.05
K_CASES = [[0.25, -0.07, 0.02, -0.003], [0.0, 0.0, 0.0, 0.0], [-0.05, 0.01, 0.0, 0.0]]


def _params(k):
    k12 = np.zeros(12, np.float32)
    k12[:4] = k
    jp = jdm.LensParams.make(k=k12, width=96, height=64, output_width=96, output_height=64)
    tp = tdm.LensParams(k=torch.from_numpy(k12), digital_lens_params=torch.zeros(16),
                        width=96.0, height=64.0, output_width=96.0, output_height=64.0)
    return jp, tp


def test_atanf_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-50, 50, 4000), rng.uniform(-3, 3, 4000),
                        [0.0, 0.41421357, 0.41421354, 2.4142137, -2.4142134, 1e-30, 1e8]])
    x = x.astype(np.float32)
    want = np.asarray(jdm._atanf(jnp.asarray(x)))
    got = tdm._atanf(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - np.arctan(x.astype(np.float64))).max() <= 1e-6


@pytest.mark.parametrize("k", K_CASES)
def test_fisheye_distort_matches_jax(k):
    jp, tp = _params(k)
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-2, 2, (2, 5000)).astype(np.float32)
    z = rng.uniform(0.2, 2.0, 5000).astype(np.float32)
    x[:3] = 0.0
    y[:3] = 0.0
    ju, jv = jdm.fisheye_distort_xy(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jp)
    tu, tv = tdm.fisheye_distort_xy(torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(z), tp)
    assert np.abs(tu.numpy() - np.asarray(ju)).max() <= TOL
    assert np.abs(tv.numpy() - np.asarray(jv)).max() <= TOL


@pytest.mark.parametrize("k", K_CASES)
def test_fisheye_undistort_matches_jax(k):
    jp, tp = _params(k)
    rng = np.random.default_rng(2)
    pt = rng.uniform(-1.2, 1.2, (3000, 2)).astype(np.float32)
    pt[0] = 0.0
    jout, jvalid = jdm.fisheye_undistort(jnp.asarray(pt), jp)
    tout, tvalid = tdm.fisheye_undistort(torch.from_numpy(pt), tp)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    ok = np.asarray(jvalid)
    assert ok.mean() > 0.9
    want = np.asarray(jout)
    assert (np.abs(tout.numpy() - want) <= TOL * np.maximum(1.0, np.abs(want)))[ok].all()


def test_radial_limit_and_registry():
    k = [0.25, -0.07, 0.02, -0.003]
    assert tdm.radial_distortion_limit(tdm.get_model("opencv_fisheye"), k) == \
        jdm.radial_distortion_limit(jdm.get_model("opencv_fisheye"), k)
    assert tdm.get_model(None).id == "opencv_fisheye"
    assert tdm.get_model("not-a-model").id == jdm.get_model("not-a-model").id
    assert tuple(tdm.MODELS) == tuple(jdm.MODELS)
    assert tdm.MODEL_IDS == jdm.MODEL_IDS
    for name, jm in jdm.MODELS.items():
        m = tdm.get_model(name)
        assert (m.id, m.name, m.is_digital) == (jm.id, jm.name, jm.is_digital)
        assert all(f is not None for f in (m.undistort, m.distort, m.distort_xy))
        assert tdm.torch_model(name) is m
        assert tdm.radial_distortion_limit(m, k) == jdm.radial_distortion_limit(jm, k)


@pytest.mark.parametrize("name", list(tdm.MODEL_IDS))
def test_remap_admits_every_model(name):
    """Every model passes the remap's gate (the torch math exists), with
    mesh data too; mesh flags without a grid size raise ValueError."""
    from gyroflow_torch.ops import remap as tremap
    from gyroflow_torch.ops.kernel_params import HAS_DIGITAL_LENS, HAS_MESH_DATA, KernelConfig
    cfg = KernelConfig(width=96, height=64, output_width=96, output_height=64,
                       distortion_model=name)
    if tdm.get_model(name).is_digital:
        cfg = cfg._replace(distortion_model="opencv_fisheye", digital_lens=name,
                           flags=HAS_DIGITAL_LENS)
        assert tremap.digital_lens(cfg).id == name
    tremap._check_supported(cfg)
    tremap._check_supported(cfg._replace(flags=cfg.flags | HAS_MESH_DATA, mesh_grid=(9, 9)))
    with pytest.raises(ValueError, match="mesh_grid"):
        tremap._check_supported(cfg._replace(flags=cfg.flags | HAS_MESH_DATA))


def _both_params(name):
    """The JAX and torch LensParams of test_distortion_models.make_params
    (a 1920x1080 plane)."""
    jp = make_params(name)
    tp = tdm.LensParams(k=torch.from_numpy(np.array(jp.k)),
                        digital_lens_params=torch.from_numpy(np.array(jp.digital_lens_params)),
                        width=1920.0, height=1080.0, output_width=1920.0, output_height=1080.0)
    return jp, tp


def _points(name, n, seed):
    """x, y, z for distort and (n, 2) points for undistort: normalised camera
    coordinates within each model's domain, pixels for the digital lenses."""
    rng = np.random.default_rng(seed)
    if tdm.get_model(name).is_digital:
        x = rng.uniform(-40, 1960, n).astype(np.float32)
        y = rng.uniform(-40, 1120, n).astype(np.float32)
        pt = np.stack([rng.uniform(0, 1920, n), rng.uniform(0, 1080, n)], -1)
        return x, y, np.ones(n, np.float32), pt.astype(np.float32)
    x, y = rng.uniform(-1.2, 1.2, (2, n)).astype(np.float32)
    z = rng.uniform(0.4, 2.0, n).astype(np.float32)
    x[:2] = 0.0
    y[:2] = 0.0
    pt = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    pt[0] = 0.0
    return x, y, z, pt


@pytest.mark.parametrize("name", list(tdm.MODEL_IDS))
def test_distort_xy_matches_jax(name):
    jp, tp = _both_params(name)
    x, y, z, _ = _points(name, 4000, 3)
    ju, jv = jdm.MODELS[name].distort_xy(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jp)
    tu, tv = tdm.MODELS[name].distort_xy(torch.from_numpy(x), torch.from_numpy(y),
                                         torch.from_numpy(z), tp)
    tol = DIGITAL_TOL_PX if tdm.get_model(name).is_digital else TOL
    for got, want in ((tu.numpy(), np.asarray(ju)), (tv.numpy(), np.asarray(jv))):
        # a fixed point that diverges (hyperview far outside its plane)
        # gives the same inf or NaN in both
        ok = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), ok)
        np.testing.assert_array_equal(got[~ok], want[~ok])
        assert ok.mean() > 0.8
        assert np.abs(got - want)[ok].max() <= tol
    # the packed form is the tuple core stacked
    np.testing.assert_array_equal(
        tdm.MODELS[name].distort(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z),
                                 tp).numpy(), np.stack([tu.numpy(), tv.numpy()], -1))


@pytest.mark.parametrize("name", list(tdm.MODEL_IDS))
def test_undistort_matches_jax(name):
    jp, tp = _both_params(name)
    _, _, _, pt = _points(name, 2000 if name != "insta360" else 400, 4)
    jout, jvalid = jdm.MODELS[name].undistort(jnp.asarray(pt), jp)
    tout, tvalid = tdm.MODELS[name].undistort(torch.from_numpy(pt), tp)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    ok = np.asarray(jvalid)
    assert ok.mean() > 0.9
    want = np.asarray(jout)
    if tdm.get_model(name).is_digital:
        assert np.abs(tout.numpy() - want)[ok].max() <= DIGITAL_TOL_PX
    else:
        assert (np.abs(tout.numpy() - want) <= TOL * np.maximum(1.0, np.abs(want)))[ok].all()


def test_gopro_warp_sentinel_and_zero_coefficients():
    """The reference's out-of-domain sentinel (a fixed point that
    oscillates) and the zero-coefficient passthroughs, as in JAX."""
    dl = np.array([5.0, 0, 0, 0, 0, 0, 0, 0, 5.0, 0, 0, 0, 0, 0, 1.0, 0], np.float32)
    tp = tdm.LensParams(k=torch.zeros(12), digital_lens_params=torch.from_numpy(dl),
                        width=1920.0, height=1080.0, output_width=1920.0, output_height=1080.0)
    u, v = tdm.gopro_warp_distort_xy(torch.tensor([1200.0]), torch.tensor([700.0]),
                                     torch.ones(1), tp)
    assert float(u) == -99999.0 and float(v) == -99999.0
    x = torch.tensor([0.3, -0.2])
    for name in ("opencv_fisheye", "sony", "generic_polynomial", "gopro"):
        u, v = tdm.MODELS[name].distort_xy(x, x, torch.ones(2), tp)
        np.testing.assert_array_equal(u.numpy(), x.numpy())


@pytest.mark.parametrize("name,loop,steps", [
    ("gopro", "_gopro_poly_invert", 10), ("gopro_superview", "_fixed_point_invert", 12),
    ("gopro6_superview", "_fixed_point_invert", 12),
    ("gopro_hyperview", "_fixed_point_invert", 12), ("gopro_warp", "_fixed_point_invert", 12)])
def test_loop_live_counts_lanes_not_done(monkeypatch, name, loop, steps):
    """A masked loop given ``live`` returns the same bits and records, step
    by step, the lanes not yet done at its start: all of them at the first
    step, then fewer as lanes converge (chip_smoke.py's bounds read them)."""
    import functools
    _, tp = _both_params(name)
    x, y, z, _ = _points(name, 4000, 3)
    if tdm.get_model(name).is_digital:      # inside the plane, where they converge
        x, y = np.clip(x, 0, 1919), np.clip(y, 0, 1079)
    args = [torch.from_numpy(a) for a in (x, y, z)]
    want = tdm.MODELS[name].distort_xy(*args, tp)
    live = []
    monkeypatch.setattr(tdm, loop, functools.partial(getattr(tdm, loop), live=live))
    got = tdm.MODELS[name].distort_xy(*args, tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    counts = [int(c) for c in live]
    assert len(counts) == steps and counts[0] == x.size
    assert all(a >= b for a, b in zip(counts, counts[1:]))
    assert sum(counts) < steps * x.size
