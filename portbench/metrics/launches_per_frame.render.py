"""Device events (kernels, copies, memsets) per frame of the profiled stretch."""
from portbench.readers import launches_per_frame


def read(t):
    return launches_per_frame(t)
