"""gyroflow_torch.entry (the port's entry points) against __graft_entry__ on
the CPU.

- ``entry(device="cpu")``'s step against the JAX ``entry()``'s step (jitted)
  at 720p on the same seeded inputs, which equal the JAX ones: the source
  coordinates within 0.05 px (valid identical), and the pixels within 1.5
  codes, the tolerance of tests/test_parallel.py:81, at all but 0.2% of
  them. The input is uniform noise, where a source position that float32
  rounding moves across one of the LUT's 32 phases changes a pixel by up to
  ~12 codes: JAX's own jitted and op-by-op steps differ so at 581 of its
  921,600 pixels, and the port's step at 583 from the jitted one.
- A 16-row band of it (``remap_plane_cuda(out_rows=16, oy0=...)``) is the
  same rows of the whole step, bit for bit, and lies within 0.25 of a code
  of ``remap_plane_pallas_jit(out_rows=16, oy0=...)`` (interpret mode) at
  all but 0.2% of its pixels, as above.
- ``dryrun_multichip`` stage 1 on 8 logical CPU shards (dp 4, sp 2) and on
  2 (dp 2, sp 1); on the cards by default, so here (no card) it raises, as
  ``entry()`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from gyroflow_torch import entry as tentry
from gyroflow_tpu.ops import remap as jremap
from gyroflow_torch.ops import remap as tremap
from gyroflow_torch.ops.kernel_params import dyn_to_torch

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

W, H = 1280, 720


def _closed(fn):
    """The step's KernelConfig and KernelDynamics, read from its closure."""
    cells = dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    return cells["cfg"], cells["dyn"]


@pytest.fixture(scope="module")
def steps():
    return tentry.entry(device="cpu"), jentry.entry()


def test_entry_inputs_match_the_jax_entry(steps):
    (_, (img, mats)), (_, (jimg, jmats)) = steps
    assert img.device.type == "cpu" and tuple(img.shape) == (H, W, 1)
    assert tuple(mats.shape) == (H, 14)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(mats.numpy(), np.asarray(jmats))


# the share of pixels a float32 rounding difference may move across a LUT
# phase (see the module docstring)
PHASE_FLIPS = 2e-3


def test_entry_step_matches_the_jax_step(steps):
    (fn, args), (jfn, jargs) = steps
    got = fn(*args)
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (H, W, 1)
    assert bool(torch.isfinite(got).all())
    assert (np.abs(got.numpy() - want) > 1.5).mean() <= PHASE_FLIPS


def test_entry_coordinates_match_the_jax_step(steps):
    (fn, (img, mats)), (jfn, (jimg, jmats)) = steps
    cfg, dyn = _closed(fn)
    jcfg, jdyn = _closed(jfn)
    dt = dyn_to_torch(dyn, "cpu")
    oy, ox = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    factor = torch.clamp_min(1.0 - dt.lens_correction_amount, 0.001)
    u, v, valid = tremap.undistort_coord(ox, oy, mats, cfg, dt, (W / 2.0, H / 2.0),
                                         (dt.f[0] / dt.fov / factor, dt.f[1] / dt.fov / factor))

    def jax_uv(jmats):
        gy, gx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                              jnp.arange(W, dtype=jnp.float32), indexing="ij")
        jfactor = jnp.maximum(1.0 - jdyn.lens_correction_amount, 0.001)
        return jremap.undistort_coord(jnp.stack([gx, gy], -1), jmats, jcfg, jdyn,
                                      (W / 2.0, H / 2.0), (jdyn.f[0] / jdyn.fov / jfactor,
                                                           jdyn.f[1] / jdyn.fov / jfactor))
    juv, jvalid = jax.jit(jax_uv)(jmats)
    juv, jvalid = np.asarray(juv), np.asarray(jvalid)
    assert np.array_equal(valid.numpy(), jvalid)
    for a, b in ((u, juv[..., 0]), (v, juv[..., 1])):
        assert np.abs(a.numpy() - b)[jvalid].max() <= 0.05


@pytest.mark.parametrize("oy0", [0, 352])
def test_entry_band_matches_pallas_band(steps, oy0):
    """16 output rows of the step through the band route against the JAX
    Pallas window's band (interpret mode) on the same inputs."""
    (fn, (img, mats)), (jfn, (jimg, jmats)) = steps
    cfg, dyn = _closed(fn)
    assert cfg.width == W and cfg.interpolation == 8
    got = tremap.remap_plane_cuda(img, mats, cfg, dyn, out_rows=16, oy0=oy0)
    jcfg, jdyn = _closed(jfn)
    want, overflow = jremap.remap_plane_pallas_jit(jimg, jmats, jcfg, jdyn, out_rows=16, oy0=oy0)
    assert not bool(overflow)
    assert tuple(got.shape) == (16, W, 1)
    assert torch.equal(got, fn(img, mats)[oy0:oy0 + 16])
    assert (np.abs(got.numpy() - np.asarray(want)) > 0.25).mean() <= PHASE_FLIPS


@pytest.mark.parametrize("n,mesh", [(8, "{'dp': 4, 'sp': 2}"), (2, "{'dp': 2, 'sp': 1}")])
def test_dryrun_smoke_stage_on_logical_shards(capsys, n, mesh):
    tentry.smoke_stage(tentry.dryrun_mesh(n, devices=["cpu"] * n))
    out = capsys.readouterr().out
    assert "dryrun_multichip smoke OK: (8, 64, 128, 1)" in out
    assert f"on mesh {mesh}" in out and out.count(" cpu") == n


def test_entry_and_dryrun_need_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        tentry.dryrun_multichip(2)
