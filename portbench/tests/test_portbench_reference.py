"""The plain reference held against the port on the CPU at a small size:
the frame transform and both planes' output agree exactly (on the CPU the
port runs the same plain remap), and the control does not."""
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, deploy

CONFIGS = ["gopro4k-preview", "sony4k-preview"]


@pytest.fixture(params=CONFIGS, scope="module")
def sides(request):
    from portbench import harness
    bench = harness.load_benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[request.param]
    cfg = dict(deploy.load_config(cell["config"], bench), width=160, height=96, clip_seconds=2)
    with tempfile.TemporaryDirectory() as d:
        tel = deploy.write_telemetry(Path(d), cfg, 2 ** 31 + 77)
        mgr = deploy.program_manager(cfg, tel, "cpu")
        ref = deploy.reference_stabilizer(cfg, tel, "cpu")
        yield cfg, mgr, ref


@pytest.mark.parametrize("frame", [0, 17, 61])
def test_frame_transform(sides, frame):
    cfg, mgr, ref = sides
    ts = deploy.timestamp_us(cfg, frame)
    ft = mgr.frame_transform_at(mgr._adjusted_ts_ms(ts))
    rt = ref.frame_transform(ts)
    assert ft.matrices.shape == rt.matrices.shape and ft.matrices.shape[0] == cfg["height"]
    np.testing.assert_array_equal(ft.matrices, rt.matrices)
    assert (ft.fov, ft.minimal_fov, ft.focal_length) == (rt.fov, rt.minimal_fov, rt.focal_length)
    assert ft.kernel_cfg == rt.kernel_cfg
    if cfg["telemetry"]["kind"] == "sony":
        assert rt.mesh_data is not None
        np.testing.assert_array_equal(ft.mesh_data, rt.mesh_data)


@pytest.mark.parametrize("frame", [3, 40])
def test_planes_agree_and_control_does_not(sides, frame):
    cfg, mgr, ref = sides
    pool = deploy.frame_pool(cfg, 5, 2, "cpu")
    ts = deploy.timestamp_us(cfg, frame)
    bgs = ref.plane_backgrounds()
    out = tuple(mgr.process_pixels(ts, plane, interpolation=8, plane_index=gi,
                                   max_pixel_value=1023.0, plane_rects=True,
                                   background_override=bgs[gi])[0]
                for gi, plane in enumerate((pool[frame % 2].y, pool[frame % 2].uv)))
    item = (frame, ts, None)
    ref_out = check.reference_frame(ref, cfg, {"interpolation": 8}, pool, item)
    assert [o.dtype for o in ref_out] == [torch.uint16, torch.uint16]
    assert check.frame_numbers(out, ref_out) == {"max_code_diff": 0, "mismatch_ppm": 0.0}
    lowp = check.reference_frame(ref, cfg, {"interpolation": 8}, pool, item, lowp=True)
    numbers = check.frame_numbers(lowp, ref_out)
    limits = cfg["check_limits"]
    assert any(numbers[k] > limits[k] for k in check.NUMBERS), numbers
