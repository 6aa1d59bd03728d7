"""The roofline counts at both configurations' 4K shapes, worked by hand, and
the published peaks in one place."""
import json
import re
from pathlib import Path

import pytest

from portbench import roofline

PKG = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((PKG / "configs" / f"{name}.json").read_text())


def test_fisheye_4k_frame():
    work = roofline.frame_work(config("gopro-hero10-4k60-fisheye"))
    y, uv = 3840 * 2160, 1920 * 1080
    # uint16 in and out: Y 1 channel, UV 2
    sample_bytes = (y * 1 + uv * 2) * 2 * 2
    assert work["sampler"] == (sample_bytes, y * 155 + uv * 300)
    assert roofline.sampler_ops(1) == 155 and roofline.sampler_ops(2) == 300
    assert work["remap"] == (sample_bytes + 2160 * 56, y * 155 + uv * 300 + (y + uv) * 2 * 77)
    assert sample_bytes == 49_766_400
    # operations bound it: 3.504 GFLOP at 67 TFLOP/s
    assert work["remap"][1] == 3_504_384_000
    assert roofline.bound_s(*work["remap"]) == pytest.approx(3.504384e9 / 67e12)
    assert roofline.bound_s(*work["sampler"]) == pytest.approx((y * 155 + uv * 300) / 67e12)


def test_sony_mesh_4k_frame():
    work = roofline.frame_work(config("sony-a7iv-4k60-mesh"))
    y, uv = 3840 * 2160, 1920 * 1080
    # 77 - 46 + 49 (the sony model); the 9x9 mesh 30 + 2 x (8 x 9 + the spline's
    # 7 x 7 + 2 x 8 + 8 + 12); FPD 36; IBIS 15
    proj = 80 + 344 + 36 + 15
    assert roofline.project_ops("sony", mesh_grid=9, fpd=True, ibis=True) == proj
    assert work["remap"][1] == y * 155 + uv * 300 + (y + uv) * 2 * proj
    assert work["remap"][1] > roofline.frame_work(config("gopro-hero10-4k60-fisheye"))["remap"][1]


def test_peaks_in_one_place():
    hits = [p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")
            if "tests" not in p.parts and re.search(r"3\.35e12|67e12", p.read_text())]
    assert hits == ["roofline.py"]
    assert (roofline.PEAK_BYTES_S, roofline.PEAK_FP32_S) == (3.35e12, 67e12)
