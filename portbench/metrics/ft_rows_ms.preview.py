"""Host ms a frame in the program's gf.ft.rows spans: the FrameTransform's per-row matrix build."""
from portbench.program_trace import span_ms


def read(t):
    return span_ms(t, "gf.ft.rows")
