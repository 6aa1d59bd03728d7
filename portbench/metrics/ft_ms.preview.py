"""Host ms per new timestamp in frame_transform_at, just before the preview's process_pixels."""
from portbench.readers import span_mean_ms


def read(t):
    return span_mean_ms(t, "ft")
