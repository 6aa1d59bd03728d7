"""Host ms per frame inside the two process_pixels calls, the FrameTransform already cached."""
from portbench.readers import span_ms_per_frame


def read(t):
    return span_ms_per_frame(t, "dispatch")
