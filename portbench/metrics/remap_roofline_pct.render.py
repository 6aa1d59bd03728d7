"""The frame's roofline bound over the device time of all its kernels, in %."""
from portbench.readers import roofline_pct


def read(t):
    return roofline_pct(t, "remap")
