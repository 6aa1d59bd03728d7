"""Device ms per frame of kernels that are not the port's own and are not copies."""
from portbench.readers import eager_device_ms


def read(t):
    return eager_device_ms(t)
