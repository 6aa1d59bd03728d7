from . import autosync, pose_estimator

__all__ = ["autosync", "pose_estimator"]
