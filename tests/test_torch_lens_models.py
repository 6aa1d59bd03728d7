"""Every reference lens model through the port's host layers, on the CPU.

For each of the 14 model ids of the reference registry, a lens profile is
loaded from JSON (``LensProfile.from_json``, which runs ``init`` and its
radial distortion limit) into the port's manager on ``device="cpu"`` and
into the JAX package's manager, the same seeded gyro log is loaded and both
recompute (smoothing, zooming). The five digital lenses (GoPro Superview,
Hyperview, warp, digital stretch) sit on a fisheye base, as real profiles
carry them. The port must give the JAX manager's fovs exactly (the host
layers are copies), and each renders a smooth 10-bit plane through
``process_pixels`` within 1 code of the JAX manager's XLA path (the uint16
cast rounds float results that differ by float rounding).
"""
import json

import numpy as np
import pytest
import torch

from gyroflow_tpu.core import lens_profile as jlp
from gyroflow_tpu.core.manager import StabilizationManager as JManager
from gyroflow_torch.core import lens_profile as tlp
from gyroflow_torch.core.manager import StabilizationManager
from gyroflow_torch.ops import distortion_models as tdm

from test_distortion_models import COEFFS, DIGITAL
from test_end_to_end import DUR_S, H, W, gcsv_path  # noqa: F401 (fixture)
from test_torch_remap import smooth_image
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# the digital lenses' parameters of test_distortion_models.make_params
DIGITAL_PARAMS = {
    "digital_stretch": [1.333333, 1.0],
    "gopro_warp": [1.05, 0.2, -0.1, 0.05, -0.01, 0.002, -0.0001, 0.02,
                   1.02, 0.05, -0.01, 0.03, -0.005, 0.001, 1.3333, 0.0],
}


def _profile_json(model_id):
    base = "opencv_fisheye" if model_id in DIGITAL else model_id
    d = {"calib_dimension": {"w": W, "h": H},
         "fisheye_params": {"camera_matrix": [[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2],
                                              [0, 0, 1]],
                            "distortion_coeffs": COEFFS[base]},
         "distortion_model": base}
    if model_id in DIGITAL:
        d.update(digital_lens=model_id, digital_lens_params=DIGITAL_PARAMS.get(model_id))
    return json.dumps(d)


def _manager(m, lens_mod, model_id, gcsv):
    m.init_from_video_data(DUR_S * 1000.0, 30.0, int(DUR_S * 30), (W, H))
    m.lens = lens_mod.LensProfile.from_json(_profile_json(model_id))
    m.params.frame_readout_time = 8.0
    m.load_gyro_data(gcsv)
    m.recompute_blocking()
    return m


@pytest.mark.parametrize("model_id", list(tdm.MODEL_IDS))
def test_profile_loads_and_recomputes_like_jax(gcsv_path, model_id):  # noqa: F811
    tm = _manager(StabilizationManager(device="cpu"), tlp, model_id, gcsv_path)
    jm = _manager(JManager(), jlp, model_id, gcsv_path)
    assert tm.lens.fisheye_params.radial_distortion_limit == \
        jm.lens.fisheye_params.radial_distortion_limit
    assert len(tm.params.fovs) == int(DUR_S * 30)
    assert tm.params.fovs == jm.params.fovs
    assert np.isfinite(tm.params.fovs).all()
    img = np.rint(smooth_image(H, W, 1)).astype(np.uint16)
    out, _ = tm.process_pixels(500_000, img, plane_index=0, max_pixel_value=1023.0,
                               plane_rects=True)
    want, _ = jm.process_pixels(500_000, img, use_pallas=False, plane_index=0,
                                max_pixel_value=1023.0, plane_rects=True)
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == img.shape
    assert np.abs(out.numpy().astype(np.int32) - np.asarray(want).astype(np.int32)).max() <= 1
