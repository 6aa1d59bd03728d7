"""Host ms a frame in the program's gf.upload spans: the frame planes' host->device copies."""
from portbench.program_trace import span_ms


def read(t):
    return span_ms(t, "gf.upload")
