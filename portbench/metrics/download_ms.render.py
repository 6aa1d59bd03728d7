"""Host ms per frame of the .cpu() downloads of both planes."""
from portbench.readers import span_ms_per_frame


def read(t):
    return span_ms_per_frame(t, "download")
