"""Host ms a frame in the program's gf.ewa.stack spans: the enqueue of ewa_stack's eager passes."""
from portbench.ewa_readers import span_ms


def read(t):
    return span_ms(t, "gf.ewa.stack")
