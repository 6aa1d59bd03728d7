"""Host ms a frame in the program's gf.eager spans: enqueuing the eager grid, coords_pre and finish."""
from portbench.program_trace import span_ms


def read(t):
    return span_ms(t, "gf.eager")
