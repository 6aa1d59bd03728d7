from .video_io import VideoReader, VideoWriter, probe_video
from .renderer import render

__all__ = ["VideoReader", "VideoWriter", "probe_video", "render"]
