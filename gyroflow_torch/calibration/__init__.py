from .calibrator import LensCalibrator

__all__ = ["LensCalibrator"]
