"""Self ms a frame of gf.process_pixels: parameters, the port's launches and waits at host syncs."""
from portbench.program_trace import span_ms


def read(t):
    return span_ms(t, "gf.process_pixels", self_time=True)
