"""No-op smoothing (smoothing/none.rs)."""
from .base import SmoothingAlgorithm


class NoSmoothing(SmoothingAlgorithm):
    def get_name(self) -> str:
        return "No smoothing"

    def params(self):
        return {}

    def get_checksum(self) -> int:
        return 0

    def smooth(self, tq, duration_ms, compute_params):
        return tq.copy()
