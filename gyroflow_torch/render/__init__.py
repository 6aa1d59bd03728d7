from .video_io import VideoReader, VideoWriter, probe_video

__all__ = ["VideoReader", "VideoWriter", "probe_video"]
