"""Host ms a frame in the program's gf.ewa.sample spans: the EWA wrapper's checks and launch."""
from portbench.ewa_readers import span_ms


def read(t):
    return span_ms(t, "gf.ewa.sample")
