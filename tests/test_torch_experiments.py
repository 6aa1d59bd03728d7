"""gyroflow_torch.experiments vs the JAX package's experiments, on the CPU.

On CPU tensors every new wrapper runs its plain version, so these tests hold
the plain versions to the JAX side on the same inputs, at small sizes:

- ``fused_bbox_plain`` against the experiment's own Pallas kernel
  (``experiments/pallas_fused.py::_fused_call``) in interpret mode. The
  experiment's module imports ``.remap`` inside its kernel, so it is loaded
  as a module of ``gyroflow_tpu.ops`` (unchanged). Its wrapper
  ``remap_fused`` is stale (it hands ``plan_matrix_windows`` (ntiles, 1, P)
  indices), so the test calls ``_fused_call`` directly with windows that
  cover the whole plane. Valid identical, bbox within 0.01 px, and 0.25 code
  in float32 (the Pallas kernel's Taylor-pair weights against the LUT) over
  the valid pixels that do not lie within 4 ulps of a half-phase tie of
  (u - offset) * 32 or (v - offset) * 32: the interpret-mode kernel's u can
  differ from the eager one by an ulp or two, which moves such a pixel to
  the neighbouring 1/32 phase, tens of codes on the probes' random content.
  50 and 60 of each case's 16384 pixels lie that close to a tie.
- ``probe_sampler_plain``: ``full`` against a numpy transcription of
  perf_probe5.py:128-188 (one-hot band matrices, the lane roll, a float32
  matmul; the JAX package's Taylor-pair weights) within 0.01 code, and
  against the JAX ``remap.sample_input`` within 0.25 code over all valid
  pixels, the half-phase ties included (57 of the Y plane's 49152 pixels
  and 8 of UV's 16384 lie at one; both sides round the same (u - 3) * 32,
  so they agree there too); ``bf16`` and
  ``bf16x3`` against the same transcription with its operands rounded by
  ``jnp.bfloat16``; ``noop``, ``nomatmul`` and ``nobuild`` against
  transcriptions of perf_probe4.py:132-207 on the same origins.
- the window column sums and the three probe-8 variants against numpy;
- each wrapper raises on a device that is neither the CPU nor a card, and
  ``perf_probe8`` imports and runs on the CPU without triton.
"""
import importlib.util
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyroflow_tpu.ops import kernel_params as jkp
from gyroflow_tpu.ops import pallas_coords as jpc
from gyroflow_tpu.ops import pallas_sampler as jps
from gyroflow_tpu.ops import remap as jremap
from gyroflow_torch import experiments
from gyroflow_torch.experiments import fused_bbox as fb
from gyroflow_torch.experiments import perf_probe as pp
from gyroflow_torch.experiments import perf_probe3 as p3
from gyroflow_torch.experiments import perf_probe4 as p4
from gyroflow_torch.experiments import perf_probe5 as p5
from gyroflow_torch.experiments import perf_probe8 as p8
from gyroflow_torch.experiments import probe_sampler as ps
from gyroflow_torch.ops import kernel_params as tkp
from gyroflow_torch.ops import remap as tremap
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parents[1]
F32_TOL = 0.25          # 10-bit codes: Taylor-pair weights vs the LUT, and the order of sums
PROBE_TOL = 0.01        # codes: the same function and weights, other summation order


def _load_experiment():
    """experiments/pallas_fused.py as gyroflow_tpu.ops._experiment_pallas_fused
    (its kernel imports .remap and .interpolation)."""
    name = "gyroflow_tpu.ops._experiment_pallas_fused"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REPO / "experiments/pallas_fused.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _tileize(a, th, tw):
    """(oh, ow, ...) -> (ntiles, th * tw, ...), tiles row-major."""
    oh, ow = a.shape[:2]
    t = a.reshape(oh // th, th, ow // tw, tw, *a.shape[2:]).swapaxes(1, 2)
    return t.reshape((oh // th) * (ow // tw), th * tw, *a.shape[2:])


def _untileize(t, oh, ow, th, tw):
    """(ntiles, th * tw, ...) -> (oh, ow, ...)."""
    a = t.reshape(oh // th, ow // tw, th, tw, *t.shape[2:]).swapaxes(1, 2)
    return a.reshape(oh, ow, *t.shape[2:])


# (channels, interpolation, background mode, fov): fov > 1 maps the frame's
# edges outside the source, where the separable background weight counts
FUSED_CASES = [(1, 8, 0, 1.2), (2, 4, 2, 1.1)]


@pytest.mark.parametrize("C,interpolation,bg_mode,fov", FUSED_CASES)
def test_fused_bbox_plain_vs_pallas_experiment(C, interpolation, bg_mode, fov):
    W, H, TH, TW = 256, 64, 8, 128           # 16 tiles; the 64 x 256 window is the plane
    f = (W * 0.62, W * 0.62)
    cfg = jkp.KernelConfig(width=W, height=H, output_width=W, output_height=H,
                           interpolation=interpolation, background_mode=bg_mode,
                           distortion_model="opencv_fisheye", plane_index=C - 1)
    dyn = jkp.KernelDynamics.make(f=f, c=(W / 2, H / 2), k=[0.25, -0.07, 0.02, -0.003],
                                  fov=fov, background=(0.1, 0.5, 0.2, 1.0),
                                  max_pixel_value=1023.0, pixel_value_limit=1023.0)
    pcfg, pdyn = tkp.from_reference(cfg, dyn)
    mats = pp.make_matrices(W, H, f, fov, H)
    img = np.random.default_rng(3).uniform(0, 1023, (H, W, C)).astype(np.float32)
    bg = tuple(float(b) * 1023.0 for b in np.asarray(dyn.background, np.float32)[:C])

    tm = torch.from_numpy(mats)
    dyn_t = tkp.dyn_to_torch(pdyn, "cpu")
    oy, ox = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    x, y, idx = tremap.coords_pre(ox, oy, tm, pcfg, dyn_t, *pp.out_cf(pcfg, dyn_t))
    out, valid, bbox = fb.fused_bbox(torch.from_numpy(img), x, y, idx, tm, pcfg, pdyn, bg, TH, TW)

    exp = _load_experiment()
    spec = jps.SamplerSpec.create(height=H, width=W, out_height=H, out_width=W,
                                  interpolation=interpolation, tile_h=TH, tile_w=TW,
                                  win_h=64, win_w=256)
    win_m, mpad = 128, 128
    matsT = np.zeros((16, mpad), np.float32)
    matsT[:14, :H] = mats.T
    ntiles = (H // TH) * (W // TW)
    tiles = [jnp.asarray(_tileize(a.numpy(), TH, TW)[:, None, :]) for a in (x, y, idx)]
    m0s = np.clip((_tileize(idx.numpy(), TH, TW).min(axis=1) // 128) * 128, 0, mpad - win_m)
    zeros = jnp.zeros(ntiles, jnp.int32)         # the window covers the plane
    j_out, j_valid, j_bbox = exp._fused_call(
        spec, cfg, win_m, jnp.asarray(matsT), jnp.asarray(np.moveaxis(img, -1, 0)), *tiles,
        jnp.asarray(m0s, jnp.int32), zeros, zeros, jpc.pack_params(dyn),
        jnp.asarray(bg, jnp.float32).reshape(1, C), interpret=True)
    j_out = _untileize(np.moveaxis(np.asarray(j_out), 1, -1), H, W, TH, TW)
    j_valid = _untileize(np.asarray(j_valid)[:, 0], H, W, TH, TW)
    j_bbox = np.asarray(j_bbox)[:, 0, :4].reshape(H // TH, W // TW, 4)

    np.testing.assert_array_equal(valid.numpy(), j_valid)
    assert valid.bool().any()
    assert out.shape == (H, W, C) and bbox.shape == (H // TH, W // TW, 4)
    u, v, _ = tremap.rotate_and_distort(x, y, idx, tm, pcfg, dyn_t)
    off = np.float32(tremap.INTERP_INFO[interpolation]["offset"])
    near_tie = np.zeros((H, W), bool)
    for a in tremap.coords_post_uv(u, v, pcfg):
        a = tremap._guard_uv(a).numpy()
        frac = ((a - off) * np.float32(32)) % 1
        near_tie |= np.abs(frac - 0.5) <= 32 * 4 * np.spacing(np.abs(a))
    assert near_tie.sum() < 0.01 * near_tie.size
    m = (valid.numpy() > 0.5) & ~near_tie
    d = np.abs(out.numpy() - j_out)[m]
    assert d.max() <= F32_TOL, d.max()
    assert np.abs(bbox.numpy() - j_bbox).max() <= 0.01


def test_tile_bbox_vs_numpy():
    rng = np.random.default_rng(5)
    u, v = rng.uniform(-50, 300, (2, 37, 70)).astype(np.float32)
    valid = rng.uniform(size=(37, 70)) > 0.3
    valid[16:32, 64:] = False                      # one tile with no valid pixel
    got = fb.tile_bbox(*(torch.from_numpy(a) for a in (u, v, valid)), 16, 32).numpy()
    assert got.shape == (3, 3, 4)
    for ty in range(3):
        for tx in range(3):
            sl = (slice(16 * ty, 16 * ty + 16), slice(32 * tx, 32 * tx + 32))
            m = valid[sl]
            want = ([u[sl][m].min(), u[sl][m].max(), v[sl][m].min(), v[sl][m].max()]
                    if m.any() else [1e9, -1e9, 1e9, -1e9])
            np.testing.assert_array_equal(got[ty, tx], np.float32(want))


# ---- numpy transcriptions of the JAX probes' kernels ------------------------

def _tap_tree(T, ws):
    level = list(ws)
    bit = 0
    while len(level) > 1:
        b = (T >> bit) & 1
        level = [np.where(b == 1, level[i + 1], level[i]) for i in range(0, len(level), 2)]
        bit += 1
    return np.where((T >= 0) & (T < len(ws)), level[0], np.float32(0.0))


def _build8(S, rel, ws):
    """perf_probe4.py:182-194: the (S, P) band of the taps ws at rel."""
    P = rel.shape[0]
    nb = S // 8
    fH, s = rel >> 3, rel & 7
    cL = np.arange(8)[:, None]
    U = _tap_tree(cL - s, ws)
    V = _tap_tree(cL + (8 - s), ws)
    bH = np.arange(nb)[:, None]
    A0 = np.broadcast_to((bH == fH)[:, None, :], (nb, 8, P)).reshape(S, P)
    A1 = np.broadcast_to((bH == fH + 1)[:, None, :], (nb, 8, P)).reshape(S, P)
    Ue = np.broadcast_to(U[None], (nb, 8, P)).reshape(S, P)
    Ve = np.broadcast_to(V[None], (nb, 8, P)).reshape(S, P)
    return np.where(A0, Ue, np.where(A1, Ve, np.float32(0.0))).astype(np.float32)


def _bf(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _probe_tiles(img, u, v, y0, x0, xoff, window, mode, precision="fp32"):
    """perf_probe4.py:119-207 and perf_probe5/6's kernels, tile by tile:
    (ntiles, P, C)."""
    H, W, C = img.shape
    Sr, Sc, K = window
    pw, ph = -(-W // 128) * 128, -(-H // 8) * 8
    padded = np.zeros((ph + Sr, pw + Sc, C), np.float32)
    padded[:H, :W] = img
    out = np.zeros(u.shape + (C,), np.float32)
    for t in range(u.shape[0]):
        win = padded[y0[t]:y0[t] + Sr, x0[t]:x0[t] + Sc]             # (Sr, Sc, C)
        if mode == "noop":
            out[t] = win[0, 0][None, :] + u[t][:, None]
            continue
        ut, vt = u[t], v[t]
        if mode == "nobuild":
            Cm = np.arange(Sc, dtype=np.float32)[:, None] * np.float32(1e-6) \
                + ut[None, :] * np.float32(1e-9)
            R = np.arange(Sr, dtype=np.float32) * np.float32(1e-6)
            for c in range(C):
                out[t, :, c] = np.sum(R[:, None] * (win[..., c] @ Cm), axis=0)
            continue
        sx0 = np.rint((ut - np.float32(3.0)) * np.float32(32)).astype(np.int32)
        sy0 = np.rint((vt - np.float32(3.0)) * np.float32(32)).astype(np.int32)
        fx, fy = sx0 >> 5, sy0 >> 5
        with np.errstate(divide="ignore", invalid="ignore"):   # phase 0 is selected away
            wx = [np.asarray(w, np.float32) for w in jps._WEIGHT_FNS[8](sx0 & 31)]
            wy = [np.asarray(w, np.float32) for w in jps._WEIGHT_FNS[8](sy0 & 31)]
        wxm = [w * ((fx + k >= 0) & (fx + k < W)).astype(np.float32) for k, w in enumerate(wx)]
        wym = [w * ((fy + k >= 0) & (fy + k < H)).astype(np.float32) for k, w in enumerate(wy)]
        csum, rsum = np.sum(wxm, axis=0), np.sum(wym, axis=0)
        Cb = _build8(K, fx - x0[t] - xoff[t], wxm)
        R = _build8(Sr, fy - y0[t], wym)
        if mode == "nomatmul":
            out[t] = ((Cb[0] * np.float32(1e-6) + R[0])[:, None] + win[0, 0][None, :]
                      + csum[:, None] + rsum[:, None])
            continue
        for c in range(C):
            wk = np.roll(win[..., c], -int(xoff[t]), axis=1)[:, :K]   # pltpu.roll
            if precision == "fp32":
                colmix = wk @ Cb
            elif precision == "bf16":
                colmix = _bf(wk) @ _bf(Cb)
            else:
                wh, ch = _bf(wk), _bf(Cb)
                colmix = wh @ ch + _bf(wk - wh) @ ch + wh @ _bf(Cb - ch)
            out[t, :, c] = np.sum(R * colmix, axis=0)       # bg 0
    return out


def _np(*ts):
    return [t.numpy() for t in ts]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
def test_probe_sampler_full_vs_numpy_probe5(precision):
    for img, u, v, valid, y0, x0, xoff, overflow, cfg, window in p5.inputs("cpu", True).values():
        assert not overflow
        got = ps.sample(img, u, v, y0, x0, xoff, window, "full", precision)
        want = _probe_tiles(*_np(img, u, v, y0, x0, xoff), window, "full", precision)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= PROBE_TOL


def test_probe_sampler_full_vs_jax_sample_input():
    """fp32 full against JAX remap.sample_input over all valid pixels,
    counting the half-phase ties among them."""
    for img, u, v, valid, y0, x0, xoff, _, cfg, window in p5.inputs("cpu", True).values():
        got = ps.sample(img, u, v, y0, x0, xoff, window, "full").numpy()
        jcfg = jkp.KernelConfig(*cfg)
        jdyn = jkp.KernelDynamics.make(max_pixel_value=1023.0, pixel_value_limit=1e30)
        want = np.asarray(jremap.sample_input(jnp.asarray(img.numpy()),
                                              jnp.stack([jnp.asarray(u), jnp.asarray(v)], -1),
                                              jnp.zeros(img.shape[2]), jcfg, jdyn))
        ties = ((np.abs(((u.numpy() - 3.0) * 32) % 1 - 0.5) == 0)
                | (np.abs(((v.numpy() - 3.0) * 32) % 1 - 0.5) == 0))
        m = valid.numpy()
        assert m.sum() > 0.5 * m.size and 0 < ties.sum() < 0.01 * m.sum()
        assert np.abs(got - want)[m].max() <= F32_TOL


@pytest.mark.parametrize("mode", ["noop", "nomatmul", "nobuild", "full"])
def test_probe_sampler_modes_vs_numpy_probe4(mode):
    img, u, v, valid, y0, x0, xoff, overflow, cfg = p4.inputs("cpu", True)
    assert not overflow and not xoff.any()
    got = ps.sample(img, u, v, y0, x0, xoff, p4.WINDOW, mode).numpy()
    want = _probe_tiles(*_np(img, u, v, y0, x0, xoff), p4.WINDOW, mode)
    assert got.shape == want.shape
    if mode == "nobuild":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        assert np.abs(got - want).max() <= PROBE_TOL


def test_probe_sampler_background_weight():
    """A non-zero bg enters through (1 - rowsum * colsum) for taps outside
    the frame: full with bg equals full without plus that term."""
    img, u, v, valid, y0, x0, xoff, _, _ = p4.inputs("cpu", True)
    u = u - float(u.min()) - 2.0                     # taps off the left edge
    a = ps.sample(img, u, v, y0, x0, xoff, p4.WINDOW, "full", bg=(100.0,))
    b = ps.sample(img, u, v, y0, x0, xoff, p4.WINDOW, "full")
    _, _, wxm, wym, csum, rsum = ps._weights(u, v, img.shape[1], img.shape[0])
    extra = (1.0 - rsum * csum)[..., None] * 100.0
    assert float(extra.abs().max()) > 50.0
    assert float((a - (b + extra)).abs().max()) <= 1e-3


def _brute_fast(fx, fy, inside_x, inside_y, taps):
    """Pixel by pixel, tap by tap: the share of the stencils at (fx, fy)
    whose every tap is inside (inside_x(x) and inside_y(y))."""
    n = 0
    for x, y in zip(fx.reshape(-1).tolist(), fy.reshape(-1).tolist()):
        n += all(inside_x(x + t) and inside_y(y + t) for t in range(taps))
    return n / fx.numel()


@pytest.mark.parametrize("C,seed", [(1, 0), (2, 1)])
def test_probe_sampler_fast_share_vs_brute_force(C, seed):
    """fast_share against a pixel-by-pixel count: each of the 64 taps in
    its tile's window rows and compute width and in the frame, on a small
    plane (11 x 13 pixels): the stencils of tile 0 end on its last pixel."""
    H, W, window = 11, 13, (9, 12, 10)
    rng = np.random.default_rng(seed)
    ntiles, P = 5, 64
    u = torch.from_numpy(rng.uniform(-4.0, W + 4.0, (ntiles, P)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-4.0, H + 4.0, (ntiles, P)).astype(np.float32))
    y0 = torch.from_numpy(rng.integers(-1, 3, ntiles).astype(np.int32))
    x0 = torch.from_numpy(rng.integers(-1, 3, ntiles).astype(np.int32))
    xoff = torch.from_numpy(rng.integers(0, 2, ntiles).astype(np.int32))
    v[0] = 3.0 + (H - 8) + 0.01
    u[0] = 3.0 + (W - 8) + 0.01
    x0[0], xoff[0], y0[0] = W - 10, 0, H - 9
    got = ps.fast_share((H, W, C), u, v, y0, x0, xoff, window)
    fx = torch.round((u - 3.0) * 32).to(torch.int64) >> 5
    fy = torch.round((v - 3.0) * 32).to(torch.int64) >> 5
    Sr, _, K = window
    n, total = 0.0, 0
    for t in range(ntiles):
        xs, ys = int(x0[t] + xoff[t]), int(y0[t])
        n += _brute_fast(fx[t], fy[t], lambda x: xs <= x < xs + K and 0 <= x < W,
                         lambda y: ys <= y < ys + Sr and 0 <= y < H, 8) * P
        total += P
    assert got == pytest.approx(n / total, abs=1e-12)
    assert 0.0 < got < 1.0


@pytest.mark.parametrize("C,interpolation", [(1, 8), (2, 8), (1, 2), (3, 4)])
def test_fused_bbox_fast_share_vs_brute_force(C, interpolation):
    """fast_share against a pixel-by-pixel count: each tap inside the
    source rect and the plane."""
    H, W = 9, 14
    cfg = tkp.KernelConfig(width=W, height=H, output_width=W, output_height=H,
                           interpolation=interpolation, source_rect=(1, 0, 12, 8))
    rng = np.random.default_rng(C + interpolation)
    u = torch.from_numpy(rng.uniform(-3.0, W + 3.0, (6, 40)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-3.0, H + 3.0, (6, 40)).astype(np.float32))
    info = tremap.INTERP_INFO[interpolation]
    taps, off = info["taps"], info["offset"]
    got = fb.fast_share(u, v, cfg, (H, W, C))
    fx = torch.round((u - off) * 32).to(torch.int64) >> 5
    fy = torch.round((v - off) * 32).to(torch.int64) >> 5
    srx, sry, srw, srh = cfg.src_rect
    want = _brute_fast(fx, fy, lambda x: srx <= x < srx + srw and 0 <= x < W,
                       lambda y: sry <= y < sry + srh and 0 <= y < H, taps)
    assert got == pytest.approx(want, abs=1e-12)
    assert 0.0 < got < 1.0


def test_window_colsum_vs_numpy():
    img, cases = p3.inputs("cpu", small=True)
    a = img.numpy().astype(np.float64)
    for align, Sc, y0, x0 in cases:
        assert not (x0.numpy() % align).any() and not (y0.numpy() % 8).any()
        got = p3.window_colsum(img, y0, x0, p3.SR, Sc).numpy()
        want = np.stack([a[y:y + p3.SR, x:x + Sc].sum(axis=0)
                         for y, x in zip(y0.numpy(), x0.numpy())])
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("Sr,Sc,y0,x0", [
    (48, 256, [-47, -48, -8, -300, 0], [-255, -256, -3, 0, -1000]),     # above, left
    (48, 160, [80, 81, 127, 128, 500], [352, 353, 511, 512, 9000]),     # below, right
    (48, 160, [-5, 100, -47, 90], [505, -100, 7, -159]),                # two edges at once
    (47, 300, [-46, 81, 40, 0], [-299, 212, 213, 3]),
    (1, 1, [-1, 0, 127, 128], [-1, 0, 511, 512]),
    (130, 520, [-1, -2, 0], [-4, 0, -8]),                               # wider than the plane
])
def test_window_colsum_edges_vs_numpy(Sr, Sc, y0, x0):
    """The plain version against the probe's ``jnp.sum(win, axis=0)`` over
    a zero-padded plane (a window past the edge reads 0), summed in row
    order in float32, bit for bit: a plane whose first and last rows and
    first columns are -0.0 shows that a window past the edge adds +0."""
    img = p3.inputs("cpu", small=True)[0].numpy().copy()
    img[:3] = img[-3:] = img[:, :2] = -0.0
    H, W = img.shape
    pad = np.zeros((H + 2 * (Sr + 1000), W + 2 * (Sc + 10000)), np.float32)
    pad[Sr + 1000:Sr + 1000 + H, Sc + 10000:Sc + 10000 + W] = img
    want = []
    for y, x in zip(y0, x0):
        win = pad[y + Sr + 1000:y + 2 * Sr + 1000, x + Sc + 10000:x + 2 * Sc + 10000]
        col = win[0].copy()
        for r in range(1, Sr):
            col = col + win[r]
        want.append(col)
    assert p3.window_path(torch.from_numpy(img), Sr, Sc) == "plain"
    got = p3.window_colsum(torch.from_numpy(img), torch.tensor(y0, dtype=torch.int32),
                           torch.tensor(x0, dtype=torch.int32), Sr, Sc).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.stack(want).view(np.int32))
    np.testing.assert_allclose(got, np.stack([pad[y + Sr + 1000:y + 2 * Sr + 1000,
                                                  x + Sc + 10000:x + 2 * Sc + 10000]
                                              .astype(np.float64).sum(axis=0)
                                              for y, x in zip(y0, x0)]), rtol=1e-5)


@pytest.mark.parametrize("variant", ["chain", "chain_plus1", "sum10"])
def test_elementwise_vs_numpy(variant):
    x1, x8 = p8.inputs("cpu", small=True)
    xn = x8.numpy()
    if variant == "sum10":
        want = np.zeros_like(xn)
        for i in range(10):
            want = want + (xn + np.float32(i))
    else:
        want = xn
        for _ in range(25):
            want = want * np.float32(1.000001) + np.float32(0.5)
            want = np.maximum(want - np.float32(0.25), np.float32(0.0))
        if variant == "chain_plus1":
            want = want + np.float32(1.0)
    got = p8.elementwise(x8, variant)
    np.testing.assert_array_equal(got.numpy().reshape(-1), want.reshape(-1))
    assert got.shape == (x8.shape if variant == "chain" else (x8.shape[0], 1, x8[0].numel()))
    if variant == "chain":
        np.testing.assert_array_equal(p8.elementwise(x1, variant).numpy().reshape(-1),
                                      want.reshape(-1))


def test_wrappers_raise_on_other_devices():
    m = torch.device("meta")
    cfg, dyn, mats, img = pp.plane_case(64, 32, 0, 1, np.random.default_rng(0))
    pcfg = cfg
    x = torch.empty(32, 64, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        fb.fused_bbox(torch.empty(32, 64, 1, device=m), x, x,
                      torch.empty(32, 64, dtype=torch.int32, device=m),
                      torch.empty(32, 14, device=m), pcfg, dyn, (0.0,))
    i32 = torch.empty(4, dtype=torch.int32, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        p3.window_colsum(torch.empty(64, 64, device=m), i32, i32)
    with pytest.raises(ValueError, match="unsupported device"):
        p3.window_path(torch.empty(64, 64, device=m))
    u = torch.empty(4, 16, device=m)
    with pytest.raises(ValueError, match="unsupported device"):
        ps.sample(torch.empty(32, 64, 1, device=m), u, u, i32, i32, i32, (8, 16, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        p8.elementwise(torch.empty(4, 8, device=m), "chain")


def test_wrappers_refuse_bad_inputs():
    img, u, v, valid, y0, x0, xoff, _, _ = p4.inputs("cpu", True)
    with pytest.raises(ValueError, match="precision"):
        ps.sample(img, u, v, y0, x0, xoff, p4.WINDOW, "noop", "bf16")
    with pytest.raises(ValueError, match="nobuild"):
        ps.sample(img, u, v, y0, x0, xoff, (65, 256, 256), "nobuild")
    with pytest.raises(ValueError, match="int32"):
        ps.sample(img, u, v, y0.long(), x0, xoff, p4.WINDOW)
    with pytest.raises(ValueError, match="variant"):
        p8.elementwise(torch.zeros(2, 4), "chain3")


def test_perf_probe8_without_triton(tmp_path):
    """perf_probe8 imports, and its wrapper runs on CPU tensors, where
    importing triton fails."""
    script = textwrap.dedent("""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "triton":
                    raise ImportError("triton is blocked")
        sys.meta_path.insert(0, Block())
        import torch
        from gyroflow_torch.experiments import perf_probe8 as p8
        out = p8.elementwise(torch.ones(2, 8), "sum10")
        assert float(out.max()) == 55.0 and "triton" not in sys.modules
        print("NO_TRITON_OK")
    """)
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env={**__import__("os").environ,
                                                      "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "NO_TRITON_OK" in res.stdout


def test_run_all_small_on_cpu():
    """Every probe runs end to end on the CPU (plain versions, no times):
    the float32 samplers equal remap.sample_input, the fused bbox equals
    the split path's."""
    r = experiments.run_all("cpu", small=True)
    assert set(r) == set(pp.PROBES)
    for name in ("Y", "UV"):
        assert r["fused_bbox"][name]["bbox_err_px"] == 0.0
        assert r["fused_bbox"][name]["max_err"] <= 1e-3
        assert r["perf_probe5"][name]["max_err"] <= 1e-3
    assert r["perf_probe4"]["full max_err"] <= 1e-3
    assert r["perf_probe4"]["base vs full max_err"] <= 1e-3
    assert r["perf_probe6"]["sampler fp32"]["err"] <= 1e-3
    assert r["perf_probe6"]["sampler bf16"]["err"] > r["perf_probe6"]["sampler bf16x3"]["err"]
    assert r["perf_probe6"]["coords kernel err px"] == [0.0, 0.0]
    assert r["perf_probe3"]["picked window Y"] is None
    assert r["perf_probe4"]["base"] is None      # no device time on the CPU


def test_untile_lays_tiles_out_as_the_frame():
    """untile inverts tiled_grid's layout: the tiled output positions land
    at their own (row, column), and a ragged tiling is refused."""
    ox, oy, pad_ok = pp.tiled_grid(384, 128, 16, 128, "cpu")
    yy, xx = torch.meshgrid(torch.arange(128.0), torch.arange(384.0), indexing="ij")
    assert torch.equal(pp.untile(ox, 384, 128, 16, 128), xx)
    assert torch.equal(pp.untile(oy, 384, 128, 16, 128), yy)
    assert bool(pp.untile(pad_ok, 384, 128, 16, 128).all())
    assert pp.untile(torch.stack([ox, oy], -1), 384, 128, 16, 128).shape == (128, 384, 2)
    with pytest.raises(ValueError, match="whole number"):
        pp.untile(ox, 384, 120, 16, 128)
