"""The EWA sampling work's roofline bound over the EWA kernel's device time, in %."""
from portbench.ewa_readers import ewa_roofline_pct


def read(t):
    return ewa_roofline_pct(t)
