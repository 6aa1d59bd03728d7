"""Host ms per frame inside process_pixels_window (both plane groups)."""
from portbench.readers import span_ms_per_frame


def read(t):
    return span_ms_per_frame(t, "dispatch")
