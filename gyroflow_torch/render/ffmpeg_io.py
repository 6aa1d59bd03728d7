"""FFmpeg-subprocess decode/encode via rawvideo pipes.

TPU-native equivalent of FfmpegProcessor (gyroflow src/rendering/
ffmpeg_processor.rs:29, ffmpeg_video.rs): the decoder feeds raw planar frames
over a pipe into host RAM (the frame-tensor boundary), the encoder consumes
raw planes and writes H.264/H.265/ProRes/FFV1 at 8/10-bit with bitrate
control and audio stream-copy from the source. Used when an `ffmpeg` binary
is present (`have_ffmpeg()`); this image has none, so tests exercise the pipe
plumbing with a stub executable and the pure-Python y4m path covers 10-bit
end-to-end.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import tempfile
from fractions import Fraction
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .formats import RAW_FORMATS, RawFormat

log = logging.getLogger(__name__)

FFMPEG = os.environ.get("GYROFLOW_TPU_FFMPEG", "ffmpeg")
FFPROBE = os.environ.get("GYROFLOW_TPU_FFPROBE", "ffprobe")


def have_ffmpeg() -> bool:
    return shutil.which(FFMPEG) is not None


def ffprobe_video(path: str) -> dict:
    """Stream metadata via ffprobe (width/height/fps/pix_fmt/nb_frames)."""
    out = subprocess.run(
        [FFPROBE, "-v", "error", "-select_streams", "v:0", "-show_entries",
         "stream=width,height,r_frame_rate,nb_frames,pix_fmt,duration",
         "-of", "json", path],
        capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise IOError(f"ffprobe failed for {path}: {out.stderr[-400:]}")
    streams = json.loads(out.stdout).get("streams", [])
    if not streams:
        raise IOError(f"No video stream in {path}")
    s = streams[0]
    num, _, den = s.get("r_frame_rate", "30/1").partition("/")
    fps = float(num) / float(den or 1)
    return {"width": int(s["width"]), "height": int(s["height"]), "fps": fps,
            "pix_fmt": s.get("pix_fmt", "yuv420p"),
            "frame_count": int(s.get("nb_frames") or 0),
            "duration": float(s.get("duration") or 0.0)}


def probe_audio_codec(path: str) -> Optional[str]:
    """Source audio codec name via ffprobe, or by parsing `ffmpeg -i` stderr
    when only the ffmpeg binary exists. None = no audio stream."""
    if shutil.which(FFPROBE) is not None:
        out = subprocess.run(
            [FFPROBE, "-v", "error", "-select_streams", "a:0",
             "-show_entries", "stream=codec_name", "-of", "json", path],
            capture_output=True, text=True, timeout=120)
        if out.returncode == 0:
            streams = json.loads(out.stdout).get("streams", [])
            return streams[0].get("codec_name") if streams else None
    out = subprocess.run([FFMPEG, "-hide_banner", "-i", path],
                         capture_output=True, text=True, timeout=120)
    for line in out.stderr.splitlines():
        line = line.strip()
        if line.startswith("Stream") and "Audio:" in line:
            return line.split("Audio:", 1)[1].strip().split(" ")[0].rstrip(",")
    return None


# audio codecs each container can stream-copy (ffmpeg_audio.rs transcodes
# through a resampler whenever the source can't be carried; we reproduce the
# decision with a compat table + `-c:a aac` fallback)
_AUDIO_COMPAT = {
    ".mp4": {"aac", "mp3", "ac3", "eac3", "alac", "opus", "mp2"},
    ".m4v": {"aac", "mp3", "ac3", "eac3", "alac", "opus", "mp2"},
    ".mov": {"aac", "mp3", "ac3", "eac3", "alac", "pcm_s16le", "pcm_s16be",
             "pcm_s24le", "pcm_s24be", "pcm_s32le", "pcm_f32le"},
    ".webm": {"opus", "vorbis"},
}

# the reference's selectable audio codecs (rendering/mod.rs:250-255)
AUDIO_CODECS = {"": "", "auto": "", "aac": "aac",
                "pcm (s16le)": "pcm_s16le", "pcm (s16be)": "pcm_s16be",
                "pcm (s24le)": "pcm_s24le", "pcm (s24be)": "pcm_s24be",
                "pcm_s16le": "pcm_s16le", "pcm_s16be": "pcm_s16be",
                "pcm_s24le": "pcm_s24le", "pcm_s24be": "pcm_s24be"}


def audio_args(out_path: str, audio_from: str, audio_codec: str = "") -> List[str]:
    """The -c:a argument set: stream-copy when the source codec fits the
    output container, else transcode (AAC fallback), matching
    ffmpeg_audio.rs:53-119 / audio_resampler.rs semantics."""
    codec = AUDIO_CODECS.get(audio_codec.lower(), audio_codec.lower())         if audio_codec else ""
    if codec:
        return ["-c:a", codec]
    ext = os.path.splitext(out_path)[1].lower()
    compat = _AUDIO_COMPAT.get(ext)
    try:
        src = probe_audio_codec(audio_from)
    except Exception:
        src = None
    if src is None or compat is None or src in compat:
        return ["-c:a", "copy"]
    fallback = "libopus" if ext == ".webm" else "aac"
    log.info("audio: %s can't stream-copy into %s — transcoding to %s",
             src, ext, fallback)
    # explicit resample keeps A/V sync when the source rate is off-spec
    return ["-c:a", fallback, "-b:a", "192k", "-af", "aresample=async=1"]


def _decode_fmt_for(src_pix_fmt: str) -> RawFormat:
    """Pick the rawvideo pix_fmt that preserves the source's depth/sampling
    (the reference's per-format plane matrix, rendering/mod.rs:564-679)."""
    if src_pix_fmt in RAW_FORMATS:
        return RAW_FORMATS[src_pix_fmt]
    # common aliases / near matches
    table = {
        "nv12": "yuv420p", "nv21": "yuv420p", "yuvj420p": "yuv420p",
        "p010le": "yuv420p10le", "p016le": "yuv420p16le",
        "yuv420p10be": "yuv420p10le", "yuv422p10be": "yuv422p10le",
        "p210le": "yuv422p10le", "yuvj422p": "yuv422p",
        "yuvj444p": "yuv444p", "p410le": "yuv444p10le",
        "gbrp": "rgb24", "bgr24": "rgb24", "bgra": "rgba", "argb": "rgba",
        "gbrap": "rgba", "rgb48be": "rgb48le", "rgba64be": "rgba64le",
        "gbrpf32be": "gbrpf32le",
    }
    name = table.get(src_pix_fmt)
    if name is None:
        # depth heuristic: 10/12/16-bit unknowns decode at 16-bit 4:4:4
        if any(t in src_pix_fmt for t in ("10", "12", "16", "f32")):
            name = "yuv444p16le"
        else:
            name = "yuv420p"
    return RAW_FORMATS[name]


class FFmpegReader:
    """Iterates (timestamp_us, planes) from an ffmpeg rawvideo pipe."""

    def __init__(self, path: str, pix_fmt: Optional[str] = None,
                 start_frame: int = 0, use_gpu: bool = True):
        info = ffprobe_video(path)
        self.width = info["width"]
        self.height = info["height"]
        self.fps = info["fps"]
        self.frame_count = info["frame_count"]
        self.src_pix_fmt = info["pix_fmt"]
        self.fmt = RAW_FORMATS[pix_fmt] if pix_fmt else _decode_fmt_for(self.src_pix_fmt)
        self._frame_bytes = self.fmt.frame_bytes(self.width, self.height)
        self._index = start_frame
        self.path = path
        self.use_gpu = use_gpu
        cmd = [FFMPEG, "-nostdin", "-v", "error"]
        if use_gpu:
            # hw-offloaded decode where a device exists; ffmpeg falls back to
            # software by itself on 'auto' (ffmpeg_hw.rs decode side)
            cmd += ["-hwaccel", "auto"]
        if start_frame:
            cmd += ["-ss", f"{start_frame / self.fps:.6f}"]
        cmd += ["-i", path, "-map", "0:v:0", "-f", "rawvideo",
                "-pix_fmt", self.fmt.name, "pipe:1"]
        # stderr goes to a spooled temp file, NOT a pipe: an un-drained pipe
        # fills at 64 KB of decode-error chatter and deadlocks the stream
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=self._err)

    @property
    def bit_depth(self) -> int:
        return self.fmt.bit_depth

    @property
    def pix_fmt(self) -> str:
        return self.fmt.name

    def seek_frame(self, frame: int):
        """Restart the pipe at the target frame (trim-range seeking,
        ffmpeg_processor.rs trim handling)."""
        self.close()
        self.__init__(self.path, self.fmt.name, start_frame=frame,
                      use_gpu=self.use_gpu)

    def __iter__(self) -> Iterator[Tuple[int, List[np.ndarray]]]:
        return self

    def __next__(self):
        buf = self.proc.stdout.read(self._frame_bytes)
        if buf is None or len(buf) < self._frame_bytes:
            raise StopIteration
        planes = self.fmt.unpack(buf, self.width, self.height)
        ts_us = int(round(self._index * 1_000_000.0 / self.fps))
        self._index += 1
        return ts_us, planes

    def close(self):
        if self.proc.stdout:
            self.proc.stdout.close()
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        if getattr(self, "_err", None) is not None:
            self._err.close()
            self._err = None


_ENCODER_CACHE: dict = {}


def available_encoders() -> set:
    """Names from `ffmpeg -encoders`, cached per binary (ffmpeg_hw.rs's
    encoder discovery; used to pick hardware encoders when present)."""
    key = FFMPEG
    if key not in _ENCODER_CACHE:
        names = set()
        try:
            out = subprocess.run([FFMPEG, "-hide_banner", "-encoders"],
                                 capture_output=True, timeout=20)
            for line in out.stdout.decode("utf-8", "replace").splitlines():
                parts = line.split()
                # " V....D libx264   H.264 / ..." — flags then name
                if len(parts) >= 2 and parts[0] and parts[0][0] in "VAS":
                    names.add(parts[1])
        except Exception:
            pass
        _ENCODER_CACHE[key] = names
    return _ENCODER_CACHE[key]


# hardware encoder preference per codec family (ffmpeg_hw.rs: nvenc > qsv >
# videotoolbox, software fallback). vaapi/amf need device + hwupload filter
# plumbing and are not attempted.
_HW_ENCODERS = {
    "h264": ("h264_nvenc", "h264_qsv", "h264_videotoolbox"),
    "hevc": ("hevc_nvenc", "hevc_qsv", "hevc_videotoolbox"),
}
_HW_WORKS_CACHE: dict = {}


def _hw_encoder_works(name: str) -> bool:
    """`-encoders` only lists compiled-in codecs; encode one synthetic frame
    to prove the device actually initializes (the reference probes candidate
    encoders the same way before committing — ffmpeg_hw.rs)."""
    if name not in _HW_WORKS_CACHE:
        try:
            r = subprocess.run(
                [FFMPEG, "-hide_banner", "-v", "error", "-f", "lavfi",
                 "-i", "color=size=128x64:rate=30", "-frames:v", "1",
                 "-c:v", name, "-f", "null", "-"],
                capture_output=True, timeout=30)
            _HW_WORKS_CACHE[name] = r.returncode == 0
        except Exception:
            _HW_WORKS_CACHE[name] = False
    return _HW_WORKS_CACHE[name]


def _pick_encoder(family: str, software: str, use_gpu: bool,
                  ten_bit: bool = False) -> str:
    # hardware H.264 encoders are 8-bit only: keep the software encoder for
    # 10-bit renders rather than silently truncating bit depth
    if use_gpu and not (family == "h264" and ten_bit):
        avail = available_encoders()
        for name in _HW_ENCODERS.get(family, ()):
            if name in avail and _hw_encoder_works(name):
                return name
    return software


def _encoder_pix_fmt(encoder: str, ten_bit: bool) -> str:
    if not ten_bit:
        return "yuv420p"
    # hw hevc encoders take the semi-planar 10-bit layout
    return "p010le" if encoder.split("_")[-1] in ("nvenc", "qsv",
                                                  "videotoolbox") \
        else "yuv420p10le"


def parse_encoder_options(s: str) -> List[str]:
    """'-key value -key2 "v 2"' -> ffmpeg args (render_queue.rs
    get_encoder_options_dict regex semantics)."""
    import re
    out: List[str] = []
    for m in re.finditer(r'-([^\s"]+)\s+("[^"]+"|[^\s"]+)', s or ""):
        out += [f"-{m.group(1)}", m.group(2).strip('"')]
    return out


# ProRes profile names (rendering/mod.rs:283-284) -> prores_ks -profile:v
_PRORES_PROFILES = {"proxy": "0", "lt": "1", "standard": "2", "hq": "3",
                    "4444": "4", "4444xq": "5"}
# DNxHR profile names -> ffmpeg dnxhd profiles (+ matching pix_fmt)
_DNX_PROFILES = {"dnxhr lb": ("dnxhr_lb", "yuv422p"),
                 "dnxhr sq": ("dnxhr_sq", "yuv422p"),
                 "dnxhr hq": ("dnxhr_hq", "yuv422p"),
                 "dnxhr hqx": ("dnxhr_hqx", "yuv422p10le"),
                 "dnxhr 444": ("dnxhr_444", "yuv444p10le")}


# codec name -> (encoder args builder); mirrors get_possible_encoders
# (rendering/mod.rs:81-185) with hardware variants chosen by discovery
def _encoder_args(codec: str, pix_fmt: str, bitrate_mbps: float,
                  use_gpu: bool = False, codec_options: str = "") -> List[str]:
    c = codec.lower()
    ten_bit = any(t in pix_fmt for t in ("10", "12", "16"))
    args: List[str] = []
    if c in ("h264", "x264", "libx264", "avc"):
        enc = _pick_encoder("h264", "libx264", use_gpu, ten_bit)
        args += ["-c:v", enc, "-pix_fmt", _encoder_pix_fmt(enc, ten_bit)]
    elif c in ("h265", "hevc", "x265", "libx265"):
        enc = _pick_encoder("hevc", "libx265", use_gpu, ten_bit)
        args += ["-c:v", enc, "-pix_fmt", _encoder_pix_fmt(enc, ten_bit)]
    elif c in ("prores", "prores_ks"):
        prof = _PRORES_PROFILES.get(codec_options.strip().lower(), "3")
        args += ["-c:v", "prores_ks", "-profile:v", prof, "-pix_fmt",
                 "yuva444p10le" if prof in ("4", "5") else "yuv422p10le"]
    elif c in ("dnxhd", "dnxhr"):
        prof, pfmt = _DNX_PROFILES.get(
            codec_options.strip().lower(),
            ("dnxhr_hqx", "yuv422p10le") if ten_bit else ("dnxhr_hq", "yuv422p"))
        args += ["-c:v", "dnxhd", "-profile:v", prof, "-pix_fmt", pfmt]
    elif c == "ffv1":
        args += ["-c:v", "ffv1", "-pix_fmt", pix_fmt]
    elif c == "rawvideo":
        args += ["-c:v", "rawvideo", "-pix_fmt", pix_fmt]
    else:
        args += ["-c:v", codec, "-pix_fmt", pix_fmt]
    if bitrate_mbps > 0:
        args += ["-b:v", f"{bitrate_mbps}M"]
    return args


class FFmpegWriter:
    """Raw planes in -> encoded file out, with optional audio stream-copy."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 pix_fmt: str = "yuv420p10le", codec: str = "h265",
                 bitrate_mbps: float = 0.0, audio_from: Optional[str] = None,
                 use_gpu: bool = False, audio_codec: str = "",
                 audio_offset_s: float = 0.0, audio_duration_s: float = 0.0,
                 preserve_other_tracks: bool = False,
                 encoder_options: str = "", keyframe_distance: float = -1.0,
                 metadata_comment: str = "", codec_options: str = ""):
        self.fmt = RAW_FORMATS[pix_fmt]
        self.width = width
        self.height = height
        self.path = path
        fr = Fraction(fps).limit_denominator(65535)
        cmd = [FFMPEG, "-y", "-v", "error",
               "-f", "rawvideo", "-pix_fmt", pix_fmt,
               "-s", f"{width}x{height}", "-r", f"{fr.numerator}/{fr.denominator}",
               "-i", "pipe:0"]
        if audio_from:
            # trimmed renders take only the rendered range of the source
            # audio (input-side seek/duration on the audio input — the
            # reference trims audio via proc.ranges_ms, rendering/mod.rs:279)
            if audio_offset_s > 0.0:
                cmd += ["-ss", f"{audio_offset_s:.6f}"]
            if audio_duration_s > 0.0:
                cmd += ["-t", f"{audio_duration_s:.6f}"]
            if preserve_other_tracks:
                # all non-video source streams ride along (the reference keeps
                # Data streams too: ffmpeg_processor.rs:300-346)
                cmd += ["-i", audio_from, "-map", "0:v", "-map", "1",
                        "-map", "-1:v", "-c:s", "copy", "-c:d", "copy",
                        "-copy_unknown"]
            else:
                cmd += ["-i", audio_from, "-map", "0:v", "-map", "1:a?"]
            cmd += audio_args(path, audio_from, audio_codec)
        cmd += _encoder_args(codec, pix_fmt, bitrate_mbps, use_gpu=use_gpu,
                             codec_options=codec_options)
        if keyframe_distance > 0:
            # keyframe interval in seconds -> GOP size (mod.rs:387
            # keyframe_distance_s)
            cmd += ["-g", str(max(int(round(fps * keyframe_distance)), 1))]
        if metadata_comment:
            cmd += ["-metadata", f"comment={metadata_comment}"]
        # advanced free-form encoder options come last so they can override
        # (render_queue.rs:104-119 get_encoder_options_dict)
        cmd += parse_encoder_options(encoder_options)
        cmd += [path]
        # spooled-file stderr: a pipe would deadlock the encode once 64 KB
        # of warnings accumulate un-drained
        self._err = tempfile.TemporaryFile()
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stderr=self._err)

    def write_planes(self, planes: List[np.ndarray]):
        shapes = self.fmt.plane_shapes(self.width, self.height)
        for a, (ph, pw, ch) in zip(planes, shapes):
            if a.shape[:2] != (ph, pw):
                raise ValueError(f"plane shape {a.shape} != expected {(ph, pw)}")
        self.fmt.write_to(self.proc.stdin, planes)

    def close(self):
        if self.proc.stdin:
            self.proc.stdin.close()
        rc = self.proc.wait()
        err = ""
        if self._err is not None:
            try:
                self._err.seek(0, os.SEEK_END)
                self._err.seek(max(self._err.tell() - 800, 0))
                err = self._err.read().decode("utf-8", "replace")
            finally:
                self._err.close()
                self._err = None
        if rc != 0:
            raise IOError(f"ffmpeg encoder exited {rc}: {err}")
