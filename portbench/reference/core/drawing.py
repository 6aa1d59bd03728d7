"""Debug-overlay draw canvas.

Port of gyroflow src/core/gpu/drawing.rs:9-97 (DrawCanvas: 1 byte/px
packing color<<3 | alpha<<1 | stage) and the in-kernel blend of
stabilize_spirv/src/drawing.rs:7-69 (COLORS/ALPHAS tables, draw_pixel,
draw_safe_area). The blend itself lives in ops/remap.py (XLA path); this
module is the host-side canvas the overlay generators draw into
(feature points, optical-flow trails, zoom debug — lib.rs:835-887).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np

# stabilize_spirv/src/drawing.rs:7-17 (RGBA, 0..1)
COLORS = np.array([
    [0, 0, 0, 0],              # None
    [255, 0, 0, 255],          # Red
    [0, 255, 0, 255],          # Green
    [0, 0, 255, 255],          # Blue
    [254, 251, 71, 255],       # Yellow
    [200, 200, 0, 255],        # Yellow2
    [255, 0, 255, 255],        # Magenta
    [0, 128, 255, 255],        # Blue2
    [0, 200, 200, 255],        # Blue3
], np.float32) / 255.0

ALPHAS = np.array([1.0, 0.75, 0.50, 0.25], np.float32)

COLOR_NONE, COLOR_RED, COLOR_GREEN, COLOR_BLUE, COLOR_YELLOW = range(5)
COLOR_YELLOW2, COLOR_MAGENTA, COLOR_BLUE2, COLOR_BLUE3 = range(5, 9)
STAGE_ON_INPUT, STAGE_ON_OUTPUT = 0, 1


class DrawingState(NamedTuple):
    """Device-facing view of the canvas, passed to remap_plane(drawing=...)."""
    canvas: np.ndarray                 # (h, w) uint8
    scale: float
    safe_area_rect: Optional[Tuple[float, float, float, float]] = None


class DrawCanvas:
    """drawing.rs:33-96."""

    def __init__(self, width: int, height: int, output_width: int,
                 output_height: int, scale: int = 1):
        self.width, self.height = width, height
        self.output_width, self.output_height = output_width, output_height
        self.scale = max(scale, 1)
        w, h = self.get_size()
        self.buffer = np.zeros((h, w), np.uint8)
        self.has_any_pixels = False

    def get_size(self) -> Tuple[int, int]:
        return (max(self.width, self.output_width) // self.scale,
                max(self.height, self.output_height) // self.scale)

    def clear(self):
        self.buffer[:] = 0
        self.has_any_pixels = False

    def put_pixel(self, x: float, y: float, color: int, alpha: int, stage: int,
                  y_inverted: bool = False, size: int = 1):
        """drawing.rs:69-87 — size×size block centered for size > 2."""
        w, h = self.get_size()
        if y_inverted:
            y = (self.height if stage == STAGE_ON_INPUT else self.output_height) - y
        if x < 0 or y < 0 or x > w * self.scale or y > h * self.scale:
            return
        adj = size / -2.0 if size > 2 else 0.0
        data = ((color & 31) << 3) | ((alpha & 3) << 1) | (stage & 1)
        for xstep in range(size):
            for ystep in range(size):
                px = math.floor(x / self.scale + xstep + adj)
                py = math.floor(y / self.scale + ystep + adj)
                if 0 <= px < w and 0 <= py < h:
                    self.buffer[py, px] = data
                    self.has_any_pixels = True

    def put_line(self, x0, y0, x1, y1, color, alpha=0, stage=STAGE_ON_INPUT,
                 size: int = 1):
        """Simple DDA for optical-flow trails (overlay gen, lib.rs:858-876)."""
        n = max(int(max(abs(x1 - x0), abs(y1 - y0))), 1)
        for i in range(n + 1):
            t = i / n
            self.put_pixel(x0 + (x1 - x0) * t, y0 + (y1 - y0) * t,
                           color, alpha, stage, size=size)

    def state(self, safe_area_rect=None) -> DrawingState:
        return DrawingState(self.buffer, float(self.scale), safe_area_rect)
