"""Minimal ISO-BMFF (MP4/MOV) demuxer for metadata tracks.

The reference delegates MP4 demuxing to the external `telemetry-parser`
crate (src/core/Cargo.toml:14); this is a from-scratch reader of just the
structures needed to locate timed-metadata samples (GoPro `gpmd` etc.):
moov → trak → mdia(hdlr, mdhd) → stbl(stsd, stts, stsz, stsc, stco/co64).
"""
from __future__ import annotations

import contextlib
import mmap
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@contextlib.contextmanager
def mapped(path: str):
    """Read-only file view WITHOUT copying it into RAM.

    Container probes walk only the moov boxes, so multi-GB clips must not be
    slurped per probe (the dispatcher tries up to 5 formats per MP4). mmap
    touches only the pages actually read; sample slices come out as plain
    bytes copies. Empty files yield b''."""
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:          # zero-length file
            yield b""
            return
        try:
            yield mm
        finally:
            mm.close()

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl"}


@dataclass
class Track:
    handler_type: bytes = b""
    handler_name: str = ""
    timescale: int = 1000
    duration: int = 0
    sample_format: bytes = b""
    sample_durations: List[Tuple[int, int]] = field(default_factory=list)  # (count, delta)
    sample_sizes: List[int] = field(default_factory=list)
    chunk_offsets: List[int] = field(default_factory=list)
    sample_to_chunk: List[Tuple[int, int]] = field(default_factory=list)   # (first_chunk, per_chunk)

    def samples(self) -> List[Tuple[int, int, float, float]]:
        """Expand tables to per-sample (offset, size, time_s, duration_s)."""
        n = len(self.sample_sizes)
        # decode times from stts
        times, t = [], 0
        for count, delta in self.sample_durations:
            for _ in range(count):
                times.append(t)
                t += delta
            if len(times) >= n:
                break
        while len(times) < n:
            times.append(t)
            t += self.sample_durations[-1][1] if self.sample_durations else 0
        durs = [(times[i + 1] - times[i]) if i + 1 < n else
                (self.sample_durations[-1][1] if self.sample_durations else 0)
                for i in range(n)]
        # sample→chunk expansion
        out = []
        si = 0
        stc = self.sample_to_chunk
        for ci, coff in enumerate(self.chunk_offsets):
            per = 1
            for first, cnt in stc:
                if ci + 1 >= first:
                    per = cnt
            off = coff
            for _ in range(per):
                if si >= n:
                    break
                out.append((off, self.sample_sizes[si],
                            times[si] / self.timescale, durs[si] / self.timescale))
                off += self.sample_sizes[si]
                si += 1
        return out


def _boxes(buf: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, pos)
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            break
        yield typ, pos + hdr, pos + size
        pos += size


def _parse_track(buf: bytes, start: int, end: int) -> Track:
    tr = Track()

    def walk(s, e):
        for typ, b, eb in _boxes(buf, s, e):
            if typ in _CONTAINERS:
                walk(b, eb)
            elif typ == b"hdlr":
                tr.handler_type = buf[b + 8:b + 12]
                name = buf[b + 24:eb]
                tr.handler_name = name.split(b"\x00")[0].decode("latin-1", "replace")
            elif typ == b"mdhd":
                ver = buf[b]
                if ver == 1:
                    tr.timescale, tr.duration = struct.unpack_from(">IQ", buf, b + 20)
                else:
                    tr.timescale, tr.duration = struct.unpack_from(">II", buf, b + 12)
            elif typ == b"stsd":
                cnt = struct.unpack_from(">I", buf, b + 4)[0]
                if cnt > 0:
                    tr.sample_format = buf[b + 12:b + 16]
            elif typ == b"stts":
                cnt = struct.unpack_from(">I", buf, b + 4)[0]
                for i in range(cnt):
                    c, d = struct.unpack_from(">II", buf, b + 8 + 8 * i)
                    tr.sample_durations.append((c, d))
            elif typ == b"stsz":
                const, cnt = struct.unpack_from(">II", buf, b + 4)
                if const:
                    tr.sample_sizes = [const] * cnt
                else:
                    tr.sample_sizes = list(struct.unpack_from(f">{cnt}I", buf, b + 12))
            elif typ == b"stsc":
                cnt = struct.unpack_from(">I", buf, b + 4)[0]
                for i in range(cnt):
                    first, per, _ = struct.unpack_from(">III", buf, b + 8 + 12 * i)
                    tr.sample_to_chunk.append((first, per))
            elif typ == b"stco":
                cnt = struct.unpack_from(">I", buf, b + 4)[0]
                tr.chunk_offsets = list(struct.unpack_from(f">{cnt}I", buf, b + 8))
            elif typ == b"co64":
                cnt = struct.unpack_from(">I", buf, b + 4)[0]
                tr.chunk_offsets = list(struct.unpack_from(f">{cnt}Q", buf, b + 8))

    walk(start, end)
    return tr


def parse_tracks(buf: bytes) -> List[Track]:
    tracks = []
    for typ, b, e in _boxes(buf, 0, len(buf)):
        if typ == b"moov":
            for t2, b2, e2 in _boxes(buf, b, e):
                if t2 == b"trak":
                    tracks.append(_parse_track(buf, b2, e2))
    return tracks


def find_metadata_track(buf: bytes, sample_format: bytes) -> Optional[Track]:
    for tr in parse_tracks(buf):
        if tr.sample_format == sample_format:
            return tr
    return None


def build_metadata_mp4(sample_format: bytes, handler_name: str,
                       payloads, fps: float = 30.0) -> bytes:
    """Single-track timed-metadata MP4 (one sample per frame, one chunk per
    sample). Shared container surgery for the Sony rtmd and Canon CTMD
    fixture/embedding builders."""
    timescale = 90000
    dur = int(round(timescale / fps))
    sizes = [len(p) for p in payloads]

    def box(typ: bytes, payload: bytes) -> bytes:
        return struct.pack(">I4s", 8 + len(payload), typ) + payload

    def full(typ, body, ver=0, flags=0):
        return box(typ, struct.pack(">I", (ver << 24) | flags) + body)

    stsd = full(b"stsd", struct.pack(">I", 1) +
                box(sample_format, b"\x00" * 6 + struct.pack(">H", 1)))
    stts = full(b"stts", struct.pack(">III", 1, len(sizes), dur))
    stsz = full(b"stsz", struct.pack(">II", 0, len(sizes)) +
                struct.pack(f">{len(sizes)}I", *sizes))
    stsc = full(b"stsc", struct.pack(">I", 1) + struct.pack(">III", 1, 1, 1))
    ftyp = box(b"ftyp", b"isom\x00\x00\x02\x00isomiso2")
    offs = [0] * len(sizes)
    out = b""
    for _ in range(2):   # second pass fills real chunk offsets
        stco = full(b"stco", struct.pack(">I", len(sizes)) +
                    struct.pack(f">{len(sizes)}I", *offs))
        stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
        minf = box(b"minf", stbl)
        hdlr = full(b"hdlr", b"\x00" * 4 + b"meta" + b"\x00" * 12 +
                    handler_name.encode() + b"\x00")
        mdhd = full(b"mdhd", struct.pack(">IIII", 0, 0, timescale,
                                         dur * len(sizes)) +
                    struct.pack(">HH", 0x55C4, 0))
        mdia = box(b"mdia", mdhd + hdlr + minf)
        trak = box(b"trak", mdia)
        moov = box(b"moov", trak)
        out = ftyp + moov
        pos = len(out) + 8   # + mdat header
        offs = []
        for s in sizes:
            offs.append(pos)
            pos += s
    return out + box(b"mdat", b"".join(payloads))
