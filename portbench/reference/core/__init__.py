from . import quaternion
from .time_quat import TimeQuat, interp_series

__all__ = ["quaternion", "TimeQuat", "interp_series"]
