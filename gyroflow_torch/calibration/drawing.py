"""Detected-corner overlay for the calibration preview.

Port of gyroflow src/core/calibration/drawing.rs (itself ported from
OpenCV's drawChessboardCorners): crosses + circles at each corner, connected
row-by-row in rotating colors when the full board was found; red crosses only
when not.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from ..core.drawing import DrawCanvas

# color indices in core.drawing.COLORS matching drawing.rs LINE_COLORS order
# (Red, Blue2, Yellow2, Green, Blue3, Blue, Magenta -> nearest table entries)
_LINE_COLORS = [2, 5, 4, 3, 6, 5, 7]
_RED = 2


def _circle(canvas: DrawCanvas, cx: float, cy: float, r: float, color: int,
            stage: int):
    steps = max(int(r * 6), 12)
    prev = None
    for i in range(steps + 1):
        a = 2.0 * math.pi * i / steps
        pt = (cx + r * math.cos(a), cy + r * math.sin(a))
        if prev is not None:
            canvas.put_line(prev[0], prev[1], pt[0], pt[1], color, stage=stage)
        prev = pt


def draw_chessboard_corners(org_width: int, org_height: int,
                            canvas: DrawCanvas,
                            pattern_size: Tuple[int, int],
                            corners: Sequence[Tuple[float, float]],
                            found: bool, inverted: bool = False,
                            stage: int = 1):
    """drawing.rs:7-60. Corners are in original-frame coordinates; the canvas
    may be smaller (preview scale)."""
    w, h = canvas.width, canvas.height
    ratio_w = w / max(org_width, 1)
    ratio_h = h / max(org_height, 1)
    r = 10.0 * ratio_w

    def xform(pt):
        x = round(pt[0] * ratio_w)
        y = round(pt[1] * ratio_h)
        if inverted:
            y = h - y
        return float(x), float(y)

    if not found:
        for c in corners:
            x, y = xform(c)
            canvas.put_line(x - r, y - r, x + r, y + r, _RED, stage=stage)
            canvas.put_line(x - r, y + r, x + r, y - r, _RED, stage=stage)
            _circle(canvas, x, y, r + 1.0, _RED, stage)
        return

    prev = None
    i = 0
    for row in range(pattern_size[1]):
        color = _LINE_COLORS[row % len(_LINE_COLORS)]
        for _col in range(pattern_size[0]):
            x, y = xform(corners[i])
            if i != 0 and prev is not None:
                canvas.put_line(prev[0], prev[1], x, y, color, stage=stage)
            canvas.put_line(x - r, y - r, x + r, y + r, color, stage=stage)
            canvas.put_line(x - r, y + r, x + r, y - r, color, stage=stage)
            _circle(canvas, x, y, r + 1.0, color, stage)
            prev = (x, y)
            i += 1
