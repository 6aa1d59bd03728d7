"""The sampling work's roofline bound over the sampler kernel's device time, in %."""
from portbench.readers import roofline_pct


def read(t):
    return roofline_pct(t, "sampler")
