"""Host ms per new timestamp in frame_transform_at, on the render's reader thread."""
from portbench.readers import span_mean_ms


def read(t):
    return span_mean_ms(t, "ft")
