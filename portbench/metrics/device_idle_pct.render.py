"""100 x (1 - device busy / wall) over the profiled stretch."""
from portbench.readers import device_idle_pct


def read(t):
    return device_idle_pct(t)
