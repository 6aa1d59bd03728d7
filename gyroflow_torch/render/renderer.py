"""Export render loop, on the manager's torch device.

A copy of gyroflow_tpu.render.renderer (port of the pipeline in gyroflow
src/rendering/mod.rs:187-679: trim ranges, video-speed frame drop/duplicate
rate control, per-frame per-plane stabilization, encode, audio passthrough)
with its device parts rewritten: frames are stabilized on ``mgr.device``
(the CUDA kernels on a card, the plain torch remap on the CPU), in windows
of frames through ``process_pixels_window`` or one by one through
``process_pixels``, and each output plane comes back to the host with
``.cpu()`` when it is encoded. There is no window ladder, so no frame is
replayed after an overflow.

Media backends (picked per file/availability):
- `.y4m`          -> pure-Python YUV4MPEG2 (8/10/12/16-bit planar YUV)
- other video     -> ffmpeg rawvideo pipes when an ffmpeg binary exists
                     (10-bit/planar, hw-agnostic), else cv2 (8-bit RGB)
- `.exr` sequence -> render/exr_seq.py (32-bit float, eval config 4)

Planar inputs run the reference's per-plane processor model
(rendering/mod.rs:564-679): luma as one kernel plane, the two chroma planes
batched as one 2-channel plane with luma-space geometry mapped through
source/output rects.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import trace
from ..ops.pixel_formats import rgb_to_yuv
from .formats import RAW_FORMATS, RawFormat
from .video_io import VideoReader, VideoWriter

log = logging.getLogger(__name__)

VIDEO_EXTS = {".mp4", ".mov", ".mkv", ".avi", ".m4v", ".webm", ".mts", ".m2ts"}


@dataclass
class RenderOptions:
    """Subset of rendering/render_queue RenderOptions."""
    codec: str = "mp4v"
    output_width: int = 0
    output_height: int = 0
    bitrate: float = 0.0               # Mbps (ffmpeg backend)
    pix_fmt: str = ""                  # output raw format (y4m/ffmpeg backends)
    use_gpu: bool = True
    audio: bool = False
    audio_codec: str = ""              # "" auto (copy/AAC fallback), "aac",
                                       # "pcm (s16le)" etc. (mod.rs:250-255)
    trim_start: float = 0.0            # fraction 0..1 (single-range shortcut;
    trim_end: float = 1.0              # manager.params.trim_ranges wins)
    pad_with_black: bool = False       # keep full timeline, fill outside the
                                       # trim ranges with the background color
                                       # (render_queue.rs:87, mod.rs:452-453)
    preserve_other_tracks: bool = False  # carry non-video source tracks
                                       # (GPMF telemetry, timecode…) into the
                                       # output; disables trimming like the
                                       # reference (render_queue.rs:86,
                                       # mod.rs:196-200)
    export_trims_separately: bool = False  # one output file per trim range,
                                       # "-001" suffix (render_queue.rs:1072,
                                       # mod.rs:697-703)
    encoder_options: str = ""          # advanced free-form ffmpeg options,
                                       # e.g. '-preset slow -crf 18'
                                       # (render_queue.rs:83)
    codec_options: str = ""            # codec profile, e.g. ProRes "HQ" /
                                       # "DNxHR HQX" (render_queue.rs:70,95-99)
    keyframe_distance: float = -1.0    # seconds between keyframes (mod.rs:387)
    metadata_comment: str = ""         # written as the output's "comment"
                                       # metadata (render_queue.rs:120-123)
    interpolation: int = 8
    safe_area: Optional[list] = None   # [x0, y0, x1, y1] output px → dim outside
    overlay: object = None             # core.drawing.DrawCanvas debug overlay
    trace: bool = False                # the tracer on for the render: per-stage
                                       # and per-span timing (SURVEY §5)
    pipeline_depth: int = 3            # frames in flight on the device queue
    # frame windows (render_queue.rs:677): 0 = auto (one frame a card over
    # several cards, 8-frame windows on one), 1 = off, N>1 = stabilize
    # N-frame windows through process_pixels_window (parallel.pipeline)
    frame_window: int = 0
    shard_sp: int = 1                  # output-row shards per frame ("sp"
                                       # axis), clipped to the card count
    async_encode: bool = True          # encode on a writer thread so the
                                       # device queue + decode overlap encode
    decode_ahead: int = 4              # decode-ahead thread queue depth
                                       # (ffmpeg_processor.rs:602 pipeline);
                                       # 0 = decode inline in the main loop


# reference names (stabilization/mod.rs:24-46, render_queue.rs settings)
_INTERP_NAMES = {"bilinear": 2, "bicubic": 4, "lanczos4": 8,
                 "ewa: robidouxsharp": 10, "ewa: robidoux": 11,
                 "ewa: mitchell": 12, "ewa: catmull-rom": 13}
_CODEC_NAMES = {"h.264/avc": "h264", "h.264": "h264", "h.265/hevc": "h265",
                "h.265": "h265", "prores": "prores", "dnxhd": "dnxhd",
                "exr sequence": "exr", "png sequence": "png"}


def apply_output_settings(options: "RenderOptions", out: dict) -> "RenderOptions":
    """Apply a project file's "output" settings object onto RenderOptions.

    Accepts the reference's key names and value spellings
    (render_queue.rs:126-145 update_from_json: codec "H.265/HEVC",
    interpolation "Lanczos4", pixel_format, metadata.comment, …)."""
    for k, v in (out or {}).items():
        if v is None:
            continue
        if k == "pixel_format" and v:
            options.pix_fmt = str(v)
        elif k == "interpolation" and v:
            if isinstance(v, str):
                options.interpolation = _INTERP_NAMES.get(
                    v.strip().lower(), options.interpolation)
            else:
                options.interpolation = int(v)
        elif k == "codec" and v:
            options.codec = _CODEC_NAMES.get(str(v).strip().lower(), str(v))
        elif k == "metadata" and isinstance(v, dict):
            options.metadata_comment = str(v.get("comment", "") or "")
        elif k in ("output_folder", "output_filename", "input_filename",
                   "input_url"):
            continue            # path routing stays with the caller
        elif hasattr(options, k):
            setattr(options, k, v)
    return options


class _AsyncWriter:
    """Background-thread writer: write_* enqueue, a worker drains to the real
    writer. Errors surface on the next call or close()."""

    def __init__(self, writer, depth: int = 4):
        import queue
        import threading
        self._w = writer
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._err is not None:
                # Keep draining after a failure: a producer blocked in
                # Queue.put() on the bounded queue would otherwise deadlock
                # (the error only surfaces via _check() on the next call).
                continue
            fn, args = item
            try:
                getattr(self._w, fn)(*args)
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                self._err = e

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def write_planes(self, planes):
        self._check()
        self._q.put(("write_planes", (planes,)))

    def write_rgb(self, frame):
        self._check()
        self._q.put(("write_rgb", (frame,)))

    def __getattr__(self, name):
        return getattr(self._w, name)

    def close(self):
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()
        self._w.close()
        self._check()


class _AsyncReader:
    """Decode-ahead thread (the ffmpeg_processor.rs:602 decode→callback
    pipeline shape): a reader thread keeps the decoder busy while the main
    loop dispatches to the device and encodes. The bounded queue applies
    backpressure so memory stays O(depth) frames. Wrap AFTER any
    seek_frame() — iteration starts immediately."""

    def __init__(self, reader, depth: int = 4, prefetch=None):
        import queue
        import threading
        self._r = reader
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._stop = False
        self._exc = None
        self._prefetch = prefetch
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="decode-ahead")
        self._t.start()

    def _put(self, item) -> bool:
        import queue
        while not self._stop:
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._r:
                if self._prefetch is not None:
                    try:
                        # warm the per-frame FrameTransform (and any other
                        # host-side per-ts work) on THIS thread so the main
                        # loop's dispatch doesn't serialize behind the
                        # ~3 ms/frame matrix build (idempotent dict fill —
                        # a lost race just recomputes on the main thread)
                        self._prefetch(item[0])
                    except Exception:  # noqa: BLE001 — prefetch is advisory
                        pass
                if not self._put(item):
                    return
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            self._exc = e
        finally:
            self._put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._exc is not None:
                    raise self._exc
                return
            yield item

    def __getattr__(self, name):
        return getattr(self._r, name)

    def close(self):
        self._stop = True
        self._t.join(timeout=10)
        self._r.close()


def open_reader(input_path: str):
    """Pick the decode backend. Returns (kind, reader): kind "planar" readers
    yield (ts_us, [plane arrays]) and expose .fmt; "rgb" yield (ts_us, HxWx3)."""
    ext = os.path.splitext(input_path)[1].lower()
    if ext == ".y4m":
        from .y4m_io import Y4MReader
        return "planar", Y4MReader(input_path)
    from .img_seq import IMG_SEQ_EXTS
    if ext == ".dng":
        from .dng_seq import DNGSequenceReader
        return "planar", DNGSequenceReader(input_path)
    if ext in IMG_SEQ_EXTS:
        from .img_seq import ImageSequenceReader
        return "planar", ImageSequenceReader(input_path)
    if ext == ".exr" or os.path.isdir(input_path) or "%" in input_path \
            or "*" in input_path:
        # sequence-ish path without an explicit image extension: PNG/TIFF if
        # any integer-format frames match, then DNG, else the float EXR reader
        from .img_seq import ImageSequenceReader, expand_sequence
        if ext != ".exr":
            if expand_sequence(input_path):
                return "planar", ImageSequenceReader(input_path)
            from .dng_seq import DNGSequenceReader
            if DNGSequenceReader._expand(input_path) and not ext:
                return "planar", DNGSequenceReader(input_path)
        from .exr_seq import EXRSequenceReader
        return "planar", EXRSequenceReader(input_path)
    from .ffmpeg_io import have_ffmpeg
    if have_ffmpeg():
        from .ffmpeg_io import FFmpegReader
        return "planar", FFmpegReader(input_path)
    return "rgb", VideoReader(input_path)


def open_writer(output_path: str, ow: int, oh: int, fps: float,
                options: RenderOptions, reader, kind: str, input_path: str,
                video_speed: float = 1.0, audio_offset_s: float = 0.0,
                audio_duration_s: float = 0.0, allow_audio: bool = True):
    """Pick the encode backend matching the reader/output container."""
    ext = os.path.splitext(output_path)[1].lower()
    if ext == ".y4m":
        from .y4m_io import Y4MWriter
        pix = options.pix_fmt or getattr(reader, "pix_fmt", "") or "yuv420p"
        return "planar", Y4MWriter(output_path, ow, oh, fps, pix)
    from .img_seq import IMG_SEQ_EXTS
    if ext == ".dng":
        raise IOError("DNG is input-only; render to .png/.exr/.y4m instead")
    if ext in IMG_SEQ_EXTS:
        from .img_seq import ImageSequenceWriter
        return "planar", ImageSequenceWriter(
            output_path, ow, oh, src_fmt=getattr(reader, "fmt", None))
    if ext in ("", ".exr") or "%" in output_path or os.path.isdir(output_path):
        from .exr_seq import EXRSequenceWriter
        return "planar", EXRSequenceWriter(
            output_path, ow, oh, src_fmt=getattr(reader, "fmt", None))
    from .ffmpeg_io import have_ffmpeg
    if have_ffmpeg():
        from .ffmpeg_io import FFmpegWriter
        pix = options.pix_fmt or getattr(reader, "pix_fmt", "") or "yuv420p"
        codec = options.codec if options.codec != "mp4v" else "h264"
        # the reference disables audio when changing speed (mod.rs:446)
        want_audio = options.audio and video_speed == 1.0 and allow_audio
        comment = options.metadata_comment
        if comment:
            # the reference prefixes the original filename (render_queue.rs:121)
            comment = (f"Original filename: {os.path.basename(input_path)}\n"
                       f"{comment}").strip()
        return "planar", FFmpegWriter(
            output_path, ow, oh, fps, pix, codec, options.bitrate,
            audio_from=input_path if want_audio else None,
            use_gpu=options.use_gpu, audio_codec=options.audio_codec,
            audio_offset_s=audio_offset_s, audio_duration_s=audio_duration_s,
            preserve_other_tracks=options.preserve_other_tracks,
            encoder_options=options.encoder_options,
            keyframe_distance=options.keyframe_distance,
            metadata_comment=comment, codec_options=options.codec_options)
    return "rgb", VideoWriter(output_path, ow, oh, fps, options.codec)


def _plane_groups(fmt: RawFormat, planes: List[np.ndarray]):
    """Group raw planes for the kernel like the reference's PixelType map:
    [Y] + [UV 2-channel] for 3-plane YUV, single group otherwise. Returns
    list of (data f32 (H,W,C), plane_index)."""
    # integer planes keep their native dtype — the manager ships uint8/uint16
    # to the device as-is (2-4x less host->device traffic) and converts
    # in-graph; float formats go out as f32
    def native(a):
        return a if a.dtype in (np.uint8, np.uint16) else a.astype(np.float32)

    if fmt.is_yuv and len(planes) == 3:
        y = native(planes[0])
        uv = native(np.concatenate([planes[1], planes[2]], axis=-1))
        return [(y, 0), (uv, 1)]
    if fmt.is_yuv and len(planes) == 2:
        # semi-planar (NV12/P010): the chroma plane is already an
        # interleaved (h/2, w/2, 2) UV pair — the kernel's native UV group
        return [(native(planes[0]), 0), (native(planes[1]), 1)]
    if len(planes) == 1:
        return [(native(planes[0]), 0)]
    # planar RGB float (gbrpf32le etc.): process as one multi-channel plane
    return [(np.concatenate(planes, axis=-1).astype(np.float32), 0)]


def _ungroup_planes(fmt: RawFormat, groups: List[np.ndarray],
                    src_max: Optional[float] = None):
    """Inverse of _plane_groups, clipped/cast to the container dtype.

    When the writer's bit depth differs from the source's, values rescale
    linearly by max-code ratio (ffmpeg's depth conversion: 8<->10<->16-bit
    YUV codes and float<->integer all scale linearly)."""
    scale = 1.0
    if src_max and src_max > 0 and fmt.max_value != src_max:
        scale = fmt.max_value / src_max
    if fmt.dtype == np.float32:
        cast = lambda a: a.astype(np.float32) * np.float32(scale) \
            if scale != 1.0 else a.astype(np.float32)
    else:
        # integer outputs usually arrive already rint+clip+cast on-device
        # (the manager's output cast) — skip the host pass then
        def cast(a):
            if scale != 1.0:
                a = np.asarray(a, np.float32) * np.float32(scale)
            elif a.dtype == fmt.dtype:
                return a
            return np.clip(np.rint(a), 0, fmt.max_value).astype(fmt.dtype)
    if fmt.is_yuv and len(fmt.planes) == 3:
        y, uv = groups
        return [cast(y), cast(uv[..., :1]), cast(uv[..., 1:2])]
    if fmt.is_yuv and len(fmt.planes) == 2:
        return [cast(groups[0]), cast(groups[1])]
    if len(fmt.planes) == 1:
        return [cast(groups[0])]
    g = groups[0]
    return [cast(g[..., i:i + 1]) for i in range(g.shape[-1])]


def _plane_backgrounds(fmt: RawFormat, bg_rgba01, limited: bool):
    """Per-plane-group background color, 0..1 (rendering/mod.rs:506-516)."""
    if fmt.is_yuv:
        yuva = rgb_to_yuv(np.asarray(bg_rgba01, np.float32), limited)
        if len(fmt.planes) in (2, 3):
            return [yuva[..., :1], yuva[..., 1:3]]
        return [yuva[..., :1]]
    bg = np.asarray(bg_rgba01, np.float32)
    if fmt.name.startswith("gbr"):
        # planar-RGB groups are concatenated in ffmpeg's G,B,R(,A) order —
        # the background must match the kernel plane's channel order
        bg = bg[[1, 2, 0, 3]] if bg.shape[-1] == 4 else bg[[1, 2, 0]]
    return [bg]


def plan_window(n_dev: int, frame_window: int, shard_sp: int, oh: int, yuv: bool):
    """The renderer's window and mesh over n_dev devices
    (gyroflow_tpu/render/renderer.py:535-560): (window, (dp, sp)), or (1,
    None) for the per-frame path. frame_window 0 picks one frame a device
    over several devices and 8 frames on one; sp is shard_sp clipped to the
    devices, dp the devices left per sp (at most the window), and the window
    rounds down to a multiple of dp. Row bands must divide every plane's
    output height (YUV's chroma is oh / 2)."""
    window = frame_window or (n_dev if n_dev > 1 else 8)
    if window <= 1:
        return 1, None
    sp = min(max(shard_sp, 1), n_dev)
    dp = max(min(n_dev // sp, window), 1)
    window = (window // dp) * dp
    if oh % (2 * sp if yuv else sp) != 0:
        return 1, None
    return window, (dp, sp)


def render(mgr, input_path: str, output_path: str,
           options: Optional[RenderOptions] = None,
           progress_cb: Optional[Callable[[float], None]] = None,
           cancel_flag: Optional[list] = None,
           trim_range_ind: Optional[int] = None,
           pause_flag: Optional[list] = None) -> dict:
    """Stabilize input video into output. Returns summary stats.

    trim_range_ind selects one of manager.params.trim_ranges (used by
    export_trims_separately, which renders each range to its own
    "-001"-suffixed file — render_queue.rs:1072, mod.rs:697-703).
    pause_flag ([bool]) suspends the loop while True (render_queue.rs
    pause/cancel flags, :614-694)."""
    options = options or RenderOptions()
    n_ranges = len(mgr.params.trim_ranges or [])
    if (options.export_trims_separately and trim_range_ind is None
            and n_ranges > 1 and not options.preserve_other_tracks):
        base, ext = os.path.splitext(output_path)
        agg: dict = {"frames": 0, "outputs": [], "fps": 0.0}
        total_t = 0.0
        for i in range(n_ranges):
            if cancel_flag and cancel_flag[0]:
                break
            sub_cb = (lambda p, _i=i: progress_cb((_i + p) / n_ranges)) \
                if progress_cb else None
            s = render(mgr, input_path, f"{base}-{i + 1:03d}{ext}", options,
                       sub_cb, cancel_flag, trim_range_ind=i,
                       pause_flag=pause_flag)
            agg["frames"] += s["frames"]
            agg["outputs"].append(s["output"])
            if s.get("fps"):
                total_t += s["frames"] / s["fps"]
            agg.update({k: v for k, v in s.items()
                        if k not in ("frames", "output", "fps")})
        agg["output"] = agg["outputs"][-1] if agg["outputs"] else output_path
        if total_t > 0:
            agg["fps"] = round(agg["frames"] / total_t, 2)
        return agg

    kind, reader = open_reader(input_path)
    # image sequences carry no timebase: the project's image_sequence_fps
    # drives frame timestamps (lib.rs:1293, rendering/mod.rs:234-239)
    seq_fps = float(getattr(mgr, "image_sequence_fps", 0.0) or 0.0)
    if seq_fps > 0.0 and hasattr(reader, "files"):
        reader.fps = seq_fps
    ow = options.output_width or mgr.params.output_size[0] or reader.width
    oh = options.output_height or mgr.params.output_size[1] or reader.height
    if (ow, oh) != tuple(mgr.params.output_size):
        # keep the manager's remap target in sync with the writer — otherwise
        # stabilized frames keep the project size and the encoder would
        # silently drop every mismatched frame (render_queue.rs output size)
        mgr.set_output_size(ow, oh)
        mgr.recompute_blocking()
    n = reader.frame_count or 1
    # trim ranges: manager.params.trim_ranges (fractions, possibly several —
    # render_queue.rs:195 renders them concatenated) win over the single-range
    # options shortcut; pad_with_black keeps the full timeline and fills
    # out-of-range frames with the background color (mod.rs:452-453)
    tr = sorted((float(a), float(b)) for a, b in (mgr.params.trim_ranges or []))
    if not tr:
        tr = [(options.trim_start, options.trim_end)]
    if options.preserve_other_tracks:
        tr = [(0.0, 1.0)]   # preserve implies full length (mod.rs:196-200)
    if trim_range_ind is not None and trim_range_ind < len(tr):
        tr = [tr[trim_range_ind]]   # export_trims_separately: one range/file
    ranges_f = [(int(a * n), int(b * n)) for a, b in tr]
    pad_black = options.pad_with_black and tr != [(0.0, 1.0)]
    first = 0 if pad_black else ranges_f[0][0]
    last = n if pad_black else ranges_f[-1][1]
    # audio follows the rendered range (rendering/mod.rs:278-279
    # proc.ranges_ms); pad_with_black keeps the full-length audio; multiple
    # concatenated ranges can't be expressed as one -ss/-t -> video-only
    allow_audio = True
    a_off = a_dur = 0.0
    if pad_black:
        pass
    elif len(ranges_f) > 1:
        allow_audio = False
        if options.audio:
            log.warning("audio dropped: multiple trim ranges render "
                        "concatenated and can't stream-copy one audio span")
    else:
        a_off = first / reader.fps if (first > 0 and reader.fps) else 0.0
        a_dur = ((min(last, n - 1) - first + 1) / reader.fps) \
            if (tr[0][1] < 1.0 and reader.fps) else 0.0
    wkind, writer = open_writer(output_path, ow, oh, reader.fps, options,
                                reader, kind, input_path,
                                video_speed=mgr.params.video_speed,
                                audio_offset_s=a_off, audio_duration_s=a_dur,
                                allow_audio=allow_audio)
    if options.async_encode:
        writer = _AsyncWriter(writer)
    fmt: Optional[RawFormat] = getattr(reader, "fmt", None)
    out_fmt: Optional[RawFormat] = getattr(writer, "fmt", None)
    if kind == "planar" and wkind == "rgb":
        raise IOError("planar input requires a planar-capable writer "
                      "(.y4m, .exr sequence, or an ffmpeg binary)")

    if first > 0:
        reader.seek_frame(first)
    if options.decode_ahead > 0:
        def _warm_ft(ts_us):
            if mgr.params.stab_enabled:
                mgr.frame_transform_at(mgr._adjusted_ts_ms(ts_us), rid=ts_us)

        reader = _AsyncReader(reader, depth=options.decode_ahead,
                              prefetch=_warm_ft)

    # frame windows: stabilize decoded frames F at a time over a mesh of the
    # cards, frames over "dp" and output-row bands over "sp", starting at the
    # manager's device (parallel/pipeline.py). Only the planar path windows
    # (the cv2 "rgb" fallback stays per-frame), and the debug overlay forces
    # the per-frame path (drawing state is per-frame). frame_window=1 opts
    # out (low-latency preview-style rendering).
    n_dev = torch.cuda.device_count() if mgr.device.type == "cuda" else 1
    window, grid = plan_window(n_dev, options.frame_window, options.shard_sp, oh,
                               fmt is not None and fmt.is_yuv)
    device_mesh = None
    show_dbg = bool(getattr(mgr.params, "show_detected_features", False)
                    or getattr(mgr.params, "show_optical_flow", False))
    if grid is not None \
            and kind == "planar" and not show_dbg \
            and options.overlay is None and options.safe_area is None:
        from ..parallel.pipeline import make_frame_mesh
        dp, sp = grid
        # the manager's card first: the window assembles on it
        others = [torch.device("cuda", i) for i in range(n_dev) if i != mgr.device.index]
        device_mesh = make_frame_mesh(dp * sp, sp=sp, devices=[mgr.device] + others) \
            if dp * sp > 1 else make_frame_mesh(1, device=mgr.device)
    else:
        window = 1

    frames_done = 0     # decoded frames (drives idx/progress)
    rendered = 0        # frames queued for encode (drives stats)
    video_speed = mgr.params.video_speed
    speed_acc = 0.0
    import time as _time
    # an episode the caller already records in goes on: the render reads
    # what it adds and leaves the tracer on
    own_trace = options.trace and not trace.TRACER.enabled
    if own_trace:
        trace.enable()
    if options.trace:
        trace_before, syncs_before = trace.totals(), trace.syncs()
    t_start = _time.time()
    inflight = []   # queued device results not yet transferred/encoded

    bgs = _plane_backgrounds(fmt, mgr.params.background, True) \
        if kind == "planar" and fmt is not None else None

    win_buf = []   # pending (ts_us, groups, emit) awaiting a full window

    _bg_cache: List = []

    def _bg_payload():
        """Constant background-color frame for pad_with_black gaps, in the
        same (group-array) layout the device step produces."""
        if _bg_cache:
            return _bg_cache[0]
        if kind != "planar":
            rgb = np.asarray(mgr.params.background[:3], np.float32) * 255.0
            payload = np.tile(np.clip(np.rint(rgb), 0, 255).astype(np.uint8),
                              (oh, ow, 1))
        else:
            shapes = fmt.plane_shapes(ow, oh)
            maxv = np.float32(fmt.max_value)
            if fmt.is_yuv and len(shapes) >= 2:
                ybg, uvbg = bgs[0].reshape(-1), bgs[1].reshape(-1)
                y = np.full((shapes[0][0], shapes[0][1], 1), ybg[0] * maxv,
                            np.float32)
                uv = np.empty((shapes[1][0], shapes[1][1], 2), np.float32)
                uv[..., 0] = uvbg[0] * maxv
                uv[..., 1] = uvbg[1] * maxv
                payload = [y, uv]
            else:
                bgv = bgs[0].reshape(-1)
                nch = sum(c for _, _, c in shapes) if len(shapes) > 1 \
                    else shapes[0][2]
                g = np.empty((oh, ow, max(nch, 1)), np.float32)
                for c in range(g.shape[-1]):
                    g[..., c] = (bgv[c] if c < bgv.size else 0.0) * maxv
                payload = [g]
        _bg_cache.append(payload)
        return payload

    def _flush_window():
        """Dispatch the buffered frames as one window per plane group; pads
        the tail window by repeating the last frame (its outputs are not
        emitted)."""
        if not win_buf:
            return
        pad = window - len(win_buf)
        entries = win_buf + [win_buf[-1]] * pad
        emits = [e for _, _, e in win_buf]
        ngroups = len(entries[0][1])
        ts_batch = [ts for ts, _, _ in entries]
        group_outs = []
        with trace.span("gf.render.stabilize"):
            for gi in range(ngroups):
                data = np.stack([g[gi][0] for _, g, _ in entries])
                plane_index = entries[0][1][gi][1]
                out, _ = mgr.process_pixels_window(
                    ts_batch, data, device_mesh,
                    interpolation=options.interpolation,
                    plane_index=plane_index, max_pixel_value=fmt.max_value,
                    plane_rects=True,
                    background_override=bgs[gi] if gi < len(bgs) else None)
                group_outs.append(out)
        for i, emit in enumerate(emits):
            inflight.append(([g[i] for g in group_outs], emit))
        win_buf.clear()

    def _host(a):
        """A device result (or a _bg_payload numpy array) on the host."""
        if not isinstance(a, torch.Tensor):
            return np.asarray(a)
        trace.sync()
        return a.cpu().numpy()

    def _emit(payload, emit):
        if kind == "planar":
            with trace.span("gf.render.stabilize"):
                groups = [_host(g) for g in payload]
                planes = _ungroup_planes(out_fmt or fmt, groups,
                                         src_max=fmt.max_value if fmt else None)
            with trace.span("gf.render.encode"):
                for _ in range(emit):
                    writer.write_planes(planes)
        else:
            with trace.span("gf.render.stabilize"):
                out_np = _host(payload)
            with trace.span("gf.render.encode"):
                for _ in range(emit):
                    writer.write_rgb(out_np)

    try:
        decoded = iter(reader)
        while True:
            with trace.span("gf.render.decode"):
                item = next(decoded, None)
            if item is None:
                break
            ts_us, frame = item
            idx = first + frames_done
            if idx > last:
                break
            if cancel_flag and cancel_flag[0]:
                break
            while pause_flag and pause_flag[0] \
                    and not (cancel_flag and cancel_flag[0]):
                _time.sleep(0.1)     # paused (render_queue.rs:614-694)
            in_range = any(a <= idx <= b for a, b in ranges_f)
            if not in_range and not pad_black:
                # gap between trim ranges: decode-and-drop (ranges render
                # concatenated, render_queue.rs:195)
                frames_done += 1
                if progress_cb:
                    progress_cb(min(frames_done / max(last - first + 1, 1), 1.0))
                continue
            # video-speed rate control (rendering/mod.rs:460-479): drop or
            # duplicate frames so output duration scales by 1/speed
            emit = 1
            if video_speed != 1.0:
                speed_acc += 1.0 / video_speed
                emit = int(speed_acc)
                speed_acc -= emit
            if emit > 0 and not in_range:
                # pad_with_black: full timeline, background outside the ranges
                if kind == "planar" and window > 1:
                    _flush_window()     # keep output ordering ahead of the pad
                inflight.append((_bg_payload(), emit))
                rendered += 1
                while len(inflight) > options.pipeline_depth:
                    _emit(*inflight.pop(0))
            elif emit > 0:
                rendered += 1
                drawing = None
                if options.overlay is not None or options.safe_area is not None \
                        or show_dbg:
                    from ..core.drawing import DrawCanvas
                    fw = frame.shape[1] if kind == "rgb" else frame[0].shape[1]
                    fh = frame.shape[0] if kind == "rgb" else frame[0].shape[0]
                    canvas = options.overlay or DrawCanvas(fw, fh, fw, fh)
                    if show_dbg:
                        # per-frame sync debug overlays (lib.rs:835-876);
                        # keep a user-supplied overlay's own pixels intact
                        mgr.draw_overlays(canvas, ts_us,
                                          clear=options.overlay is None)
                    rect = tuple(float(v) for v in options.safe_area) \
                        if options.safe_area else None
                    drawing = canvas.state(safe_area_rect=rect)
                if kind == "planar" and window > 1:
                    with trace.span("gf.render.stabilize"):
                        groups = _plane_groups(fmt, frame)
                    win_buf.append((ts_us, groups, emit))
                    if len(win_buf) == window:
                        _flush_window()
                elif kind == "planar":
                    with trace.span("gf.render.stabilize"):
                        groups = _plane_groups(fmt, frame)
                        outs = []
                        for gi, (data, plane_index) in enumerate(groups):
                            out, _ = mgr.process_pixels(
                                ts_us, data, interpolation=options.interpolation,
                                plane_index=plane_index,
                                max_pixel_value=fmt.max_value,
                                plane_rects=True,
                                background_override=bgs[gi] if gi < len(bgs) else None,
                                drawing=drawing if plane_index == 0 else None)
                            outs.append(out)
                    inflight.append((outs, emit))
                else:
                    with trace.span("gf.render.stabilize"):
                        out, _ = mgr.process_pixels(
                            ts_us, frame, interpolation=options.interpolation,
                            drawing=drawing)
                    inflight.append((out, emit))
                # depth-k dispatch pipeline: the device queue keeps computing
                # frame N+1..N+k while frame N transfers back and encodes
                while len(inflight) > options.pipeline_depth:
                    _emit(*inflight.pop(0))
            frames_done += 1
            if progress_cb:
                progress_cb(min(frames_done / max(last - first + 1, 1), 1.0))
        _flush_window()
        while inflight:
            _emit(*inflight.pop(0))
    finally:
        if own_trace:
            trace.disable()
        reader.close()
        writer.close()

    audio_copied = wkind == "planar" and options.audio and \
        getattr(writer, "proc", None) is not None
    if options.audio and (video_speed != 1.0 or not allow_audio):
        audio_copied = False        # reference: no audio when changing speed
    elif options.audio and not audio_copied \
            and output_path.lower().endswith((".mp4", ".mov")) \
            and input_path.lower().endswith((".mp4", ".mov")):
        # passthrough remux (ffmpeg stream-copy equivalent, rendering/mod.rs:425)
        from ..utils.mp4mux import remux_with_audio
        tmp = output_path + ".remux.mp4"
        try:
            if remux_with_audio(output_path, input_path, tmp,
                                offset_s=a_off, duration_s=a_dur,
                                preserve_other_tracks=options.preserve_other_tracks):
                os.replace(tmp, output_path)
                audio_copied = True
        except Exception as e:
            log.warning("audio passthrough failed, keeping video-only: %s", e)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    # carry the source's modification time onto the output, offset by the
    # render start within the clip (util.rs:476-501 update_file_times)
    try:
        st = os.stat(input_path)
        os.utime(output_path, (st.st_atime + a_off, st.st_mtime + a_off))
    except OSError:
        pass

    wall = _time.time() - t_start
    stats = {"frames": rendered, "output": output_path, "audio": audio_copied,
             "backend": "cuda" if mgr.device.type == "cuda" else "torch-cpu",
             "pix_fmt": getattr(out_fmt, "name", "rgb24"),
             "fps": round(rendered / wall, 2) if wall > 0 else 0.0}
    if device_mesh is not None:
        stats["backend"] += "-window"
        stats["frame_window"] = window
        stats["mesh"] = dict(device_mesh.shape)
    if options.trace:
        # per-stage timing summary (SURVEY §5: structured per-stage timing +
        # the frames/sec north-star counter) from the tracer's spans: decode
        # includes the reader wait, stabilize the dispatch and the result's
        # transfer, encode the writer's marshal; then every span's ms a
        # frame and the host syncs a frame, each less what the episode held
        # before the render
        secs = {k: t.seconds - (trace_before[k].seconds if k in trace_before else 0.0)
                for k, t in sorted(trace.totals().items())
                if t.count > (trace_before[k].count if k in trace_before else 0)}
        t_decode, t_stab, t_encode = (
            secs.get(k, 0.0) for k in ("gf.render.decode", "gf.render.stabilize",
                                       "gf.render.encode"))
        stats["trace"] = {"decode_s": round(t_decode, 3),
                          "stabilize_s": round(t_stab, 3),
                          "encode_s": round(t_encode, 3),
                          "wall_s": round(wall, 3),
                          "ms_per_frame": {k: round(v * 1e3 / max(rendered, 1), 3)
                                           for k, v in secs.items()},
                          "host_syncs_per_frame": round((trace.syncs() - syncs_before) /
                                                        max(rendered, 1), 2)}
        log.info("trace: %d frames in %.2fs (%.2f fps) | decode %.2fs, "
                 "stabilize %.2fs (%.1f ms/frame), encode %.2fs | ms/frame %s",
                 rendered, wall, stats["fps"], t_decode, t_stab,
                 t_stab / max(rendered, 1) * 1000.0, t_encode,
                 stats["trace"]["ms_per_frame"])
    return stats
