"""gyroflow_torch fisheye model vs the JAX package's, on the CPU.

Same points (numpy seed) through ``gyroflow_tpu.ops.distortion_models`` and
``gyroflow_torch.ops.distortion_models``. Tolerance: 1e-5 in normalised
coordinates (the same float32 ops; XLA and torch may round tan/sqrt a few
ulp apart). The undistort's result is tan(theta), which grows without bound
near theta = pi/2 (a barrel lens at a large radius), so there the limit is
1e-5 of the coordinate's magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import distortion_models as jdm
from gyroflow_torch.ops import distortion_models as tdm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
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
    assert tdm.REFERENCE_MODEL_IDS == tuple(jdm.MODELS)
    for name, jm in jdm.MODELS.items():
        m = tdm.get_model(name)
        assert (m.id, m.name, m.is_digital) == (jm.id, jm.name, jm.is_digital)
        ported = name == "opencv_fisheye"
        assert all((f is not None) == ported for f in (m.undistort, m.distort, m.distort_xy))
        assert tdm.radial_distortion_limit(m, k) == jdm.radial_distortion_limit(jm, k)


@pytest.mark.parametrize("name", sorted(set(tdm.REFERENCE_MODEL_IDS) - {"opencv_fisheye"}))
def test_remap_raises_for_models_without_torch_math(name):
    """Each model without torch math yet resolves (the host layers run), and
    the remap raises where it needs the math, citing ROADMAP queue 1,
    item 3."""
    from gyroflow_torch.ops import remap as tremap
    from gyroflow_torch.ops.kernel_params import KernelConfig
    assert tdm.get_model(name).id == name
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        tdm.torch_model(name)
    cfg = KernelConfig(width=96, height=64, output_width=96, output_height=64,
                       distortion_model=name)
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        tremap._check_supported(cfg)
