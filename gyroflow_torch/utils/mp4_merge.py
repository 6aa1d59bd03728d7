"""Join chaptered MP4/MOV recordings into one file (container-level merge).

Port of the reference's mp4_merge flow (gyroflow src/controller.rs:2179
-2246), whose container surgery lives in the external `mp4-merge` crate: the
output keeps the first chapter's structure, every chapter's `mdat` payload is
concatenated, and the per-track sample tables (stts/stsz/stsc/stco/stss/ctts)
are merged with rebased chunk offsets and renumbered chunks/samples; movie,
track and media durations are summed. Cameras split long recordings at the
FAT 4 GiB boundary (GoPro chapters, Sony C-files); the merged file is what
telemetry parsing and rendering consume.

Only same-recording chapters merge: track count/handlers/timescales must
match, and every track's stsd sample description (codec fourcc + visual
width/height) must be identical across chapters — two recordings with the
same track layout but different resolutions are rejected instead of
producing a file that decodes corrupt from the second chapter on."""
from __future__ import annotations

import os
import struct
from typing import List, Optional

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl"}


class Box:
    __slots__ = ("typ", "payload", "children")

    def __init__(self, typ: bytes, payload: Optional[bytes] = None,
                 children: Optional[List["Box"]] = None):
        self.typ = typ
        self.payload = payload
        self.children = children

    def find(self, typ: bytes) -> Optional["Box"]:
        for c in self.children or ():
            if c.typ == typ:
                return c
        return None

    def serialize(self) -> bytes:
        body = self.payload if self.payload is not None else \
            b"".join(c.serialize() for c in self.children or ())
        if len(body) + 8 > 0xFFFFFFFF:
            return struct.pack(">I4sQ", 1, self.typ, len(body) + 16) + body
        return struct.pack(">I4s", len(body) + 8, self.typ) + body


def _parse(buf: bytes, s: int, e: int) -> List[Box]:
    out = []
    pos = s
    while pos + 8 <= e:
        size = struct.unpack_from(">I", buf, pos)[0]
        typ = buf[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = e - pos
        if size < hdr or pos + size > e:
            break
        body_s, body_e = pos + hdr, pos + size
        if typ in CONTAINERS:
            out.append(Box(typ, children=_parse(buf, body_s, body_e)))
        else:
            out.append(Box(typ, payload=buf[body_s:body_e]))
        pos += size
    return out


def _read_table(payload: bytes, entry_words: int) -> List[tuple]:
    n = struct.unpack_from(">I", payload, 4)[0]
    fmt = ">" + "I" * entry_words
    return [struct.unpack_from(fmt, payload, 8 + i * 4 * entry_words)
            for i in range(n)]


def _write_table(version_flags: bytes, entries: List[tuple]) -> bytes:
    words = len(entries[0]) if entries else 1
    out = [version_flags, struct.pack(">I", len(entries))]
    fmt = ">" + "I" * words
    out += [struct.pack(fmt, *e) for e in entries]
    return b"".join(out)


def _stsz_sizes(payload: bytes) -> List[int]:
    uniform, count = struct.unpack_from(">II", payload, 4)
    if uniform:
        return [uniform] * count
    return list(struct.unpack_from(">" + "I" * count, payload, 12))


def _chunk_offsets(stbl: Box) -> List[int]:
    co = stbl.find(b"stco")
    if co is not None:
        return [e[0] for e in _read_table(co.payload, 1)]
    co = stbl.find(b"co64")
    n = struct.unpack_from(">I", co.payload, 4)[0]
    return list(struct.unpack_from(">" + "Q" * n, co.payload, 8))


def _duration(payload: bytes, kind: str) -> int:
    v = payload[0]
    if kind == "mvhd" or kind == "mdhd":
        return struct.unpack_from(">Q", payload, 24)[0] if v == 1 else \
            struct.unpack_from(">I", payload, 16)[0]
    # tkhd: creation/modification/track_id/reserved then duration
    return struct.unpack_from(">Q", payload, 28)[0] if v == 1 else \
        struct.unpack_from(">I", payload, 20)[0]


def _set_duration(payload: bytes, kind: str, value: int) -> bytes:
    v = payload[0]
    b = bytearray(payload)
    if kind in ("mvhd", "mdhd"):
        off, fmt = (24, ">Q") if v == 1 else (16, ">I")
    else:
        off, fmt = (28, ">Q") if v == 1 else (20, ">I")
    struct.pack_into(fmt, b, off, min(value, (1 << (64 if fmt == ">Q" else 32)) - 1))
    return bytes(b)


def _timescale(payload: bytes, kind: str) -> int:
    v = payload[0]
    off = 20 if v == 1 else 12
    return struct.unpack_from(">I", payload, off)[0]


def _chunk_sample_counts(stsc, nchunks: int, nsamples: int):
    """Expand stsc runs into exact per-chunk (count, sdi) pairs.

    ISO 14496-12 bounds the table by the file's sample count, so the final
    chunk may really hold FEWER samples than its run claims; after a merge
    the samples no longer run out there, so the partial chunk must be made
    explicit or every later sample maps into the wrong chunk."""
    per_chunk = []
    runs = list(stsc)
    for i, (first, per, sdi) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else nchunks
        per_chunk += [(per, sdi)] * max(last - first + 1, 0)
    per_chunk = per_chunk[:nchunks]
    total = 0
    out = []
    for (c, sdi) in per_chunk:
        take = min(c, max(nsamples - total, 0))
        out.append((take, sdi))
        total += take
    return out


class _TrackTables:
    """Merged-in-progress sample tables of one track."""

    def __init__(self, stbl: Box):
        self.stts = _read_table(stbl.find(b"stts").payload, 2)
        self.sizes = _stsz_sizes(stbl.find(b"stsz").payload)
        self.offsets = _chunk_offsets(stbl)
        self.chunks = _chunk_sample_counts(
            _read_table(stbl.find(b"stsc").payload, 3),
            len(self.offsets), len(self.sizes))
        ss = stbl.find(b"stss")
        self.stss = [e[0] for e in _read_table(ss.payload, 1)] if ss else None
        ct = stbl.find(b"ctts")
        self.ctts = _read_table(ct.payload, 2) if ct else None

    def append(self, o: "_TrackTables", offset_map):
        nsamples = len(self.sizes)
        for (cnt, delta) in o.stts:
            if self.stts and self.stts[-1][1] == delta:
                self.stts[-1] = (self.stts[-1][0] + cnt, delta)
            else:
                self.stts.append((cnt, delta))
        # sync samples: a missing stss means EVERY sample is sync — expand
        # when only one side has the box, else the merged table would mark
        # a whole chapter's frames non-seekable
        if self.stss is not None or o.stss is not None:
            if self.stss is None:
                self.stss = list(range(1, nsamples + 1))
            o_stss = o.stss if o.stss is not None \
                else range(1, len(o.sizes) + 1)
            self.stss += [s + nsamples for s in o_stss]
        # composition offsets: missing ctts == all-zero offsets
        if self.ctts is not None or o.ctts is not None:
            if self.ctts is None:
                self.ctts = [(nsamples, 0)] if nsamples else []
            self.ctts += o.ctts if o.ctts is not None \
                else ([(len(o.sizes), 0)] if o.sizes else [])
        self.sizes += o.sizes
        self.chunks += o.chunks
        self.offsets += [offset_map(x) for x in o.offsets]

    def _stsc_runs(self):
        runs = []
        for i, (cnt, sdi) in enumerate(self.chunks, start=1):
            if runs and runs[-1][1] == cnt and runs[-1][2] == sdi:
                continue
            runs.append((i, cnt, sdi))
        return runs

    def patch(self, stbl: Box):
        vf0 = lambda b: bytes(b.payload[:4])
        stbl.find(b"stts").payload = _write_table(vf0(stbl.find(b"stts")),
                                                  [tuple(e) for e in self.stts])
        stbl.find(b"stsz").payload = (vf0(stbl.find(b"stsz")) +
                                      struct.pack(">II", 0, len(self.sizes)) +
                                      struct.pack(">" + "I" * len(self.sizes),
                                                  *self.sizes))
        stbl.find(b"stsc").payload = _write_table(vf0(stbl.find(b"stsc")),
                                                  self._stsc_runs())
        # chunk offsets: upgrade to co64 when the merged file crosses 4 GiB
        co = stbl.find(b"stco") or stbl.find(b"co64")
        if max(self.offsets, default=0) > 0xFFFFFFFF:
            co.typ = b"co64"
            co.payload = (b"\x00\x00\x00\x00" +
                          struct.pack(">I", len(self.offsets)) +
                          struct.pack(">" + "Q" * len(self.offsets), *self.offsets))
        else:
            co.typ = b"stco"
            co.payload = (b"\x00\x00\x00\x00" +
                          struct.pack(">I", len(self.offsets)) +
                          struct.pack(">" + "I" * len(self.offsets), *self.offsets))
        if self.stss is not None:
            box = stbl.find(b"stss")
            if box is None:
                box = Box(b"stss", payload=b"\x00\x00\x00\x00")
                stbl.children.append(box)
            box.payload = _write_table(vf0(box), [(s,) for s in self.stss])
        if self.ctts is not None:
            box = stbl.find(b"ctts")
            if box is None:
                box = Box(b"ctts", payload=b"\x00\x00\x00\x00")
                stbl.children.append(box)
            box.payload = _write_table(vf0(box), [tuple(e) for e in self.ctts])


def _top_boxes(buf: bytes):
    """Top-level (typ, hdr_size, start, end) spans."""
    out = []
    pos = 0
    while pos + 8 <= len(buf):
        size = struct.unpack_from(">I", buf, pos)[0]
        typ = buf[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            hdr = 16
        elif size == 0:
            size = len(buf) - pos
        if size < hdr or pos + size > len(buf):
            break
        out.append((typ, hdr, pos, pos + size))
        pos += size
    return out


def _traks(moov: Box) -> List[Box]:
    return [c for c in moov.children if c.typ == b"trak"]


def _handler(trak: Box) -> bytes:
    mdia = trak.find(b"mdia")
    hdlr = mdia.find(b"hdlr") if mdia else None
    return hdlr.payload[8:12] if hdlr else b"????"


def _sample_desc(trak: Box) -> tuple:
    """(codec fourcc, width, height) of the first stsd sample entry.

    For visual entries (ISO 14496-12 §12.1.3) width/height sit at bytes
    24-28 of the entry body; non-video tracks return (fourcc, 0, 0)."""
    mdia = trak.find(b"mdia")
    minf = mdia.find(b"minf") if mdia else None
    stbl = minf.find(b"stbl") if minf else None
    stsd = stbl.find(b"stsd") if stbl else None
    if stsd is None or len(stsd.payload) < 16:
        return (b"????", 0, 0)
    p = stsd.payload
    fourcc = p[12:16]
    if _handler(trak) == b"vide" and len(p) >= 8 + 8 + 28:
        w, h = struct.unpack_from(">HH", p, 8 + 8 + 24)
        return (fourcc, w, h)
    return (fourcc, 0, 0)


def merge_mp4(file_list: List[str], output_path: str) -> dict:
    """Merge chapters into `output_path`. Returns {"files": n, "bytes": n}.

    Raises IOError on structural mismatch (different track layout or
    timescales — not chapters of one recording)."""
    if len(file_list) < 2:
        raise IOError("need at least two files to merge")

    # chapters are ~4 GiB each: map them instead of reading into memory
    # (only the parsed moov boxes are copied; mdat bytes stream at write time)
    import mmap
    files = [open(p, "rb") for p in file_list]
    try:
        bufs = [mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                for f in files]
    except (ValueError, OSError):        # zero-length or mmap-less fs
        bufs = [f.read() for f in files]
    parsed = []
    for p, buf in zip(file_list, bufs):
        tops = _top_boxes(buf)
        moov_span = next((t for t in tops if t[0] == b"moov"), None)
        mdats = [t for t in tops if t[0] == b"mdat"]
        if moov_span is None or not mdats:
            raise IOError(f"not a usable MP4 (no moov/mdat): {p}")
        moov = Box(b"moov", children=_parse(buf, moov_span[2] + moov_span[1],
                                            moov_span[3]))
        parsed.append((buf, tops, moov, mdats))

    base_buf, base_tops, base_moov, _ = parsed[0]
    base_traks = _traks(base_moov)
    for p, (_b, _t, moov, _m) in zip(file_list[1:], [x for x in parsed[1:]]):
        traks = _traks(moov)
        if len(traks) != len(base_traks) or any(
                _handler(a) != _handler(b) for a, b in zip(base_traks, traks)):
            raise IOError(f"track layout mismatch: {p}")
        for a, b in zip(base_traks, traks):
            if _sample_desc(a) != _sample_desc(b):
                raise IOError(
                    f"sample description mismatch (codec/dimensions): {p} "
                    f"{_sample_desc(a)} != {_sample_desc(b)}")

    # Output layout: ftyp (from file 1), one big mdat, merged moov.
    ftyp = next((t for t in base_tops if t[0] == b"ftyp"), None)
    ftyp_bytes = base_buf[ftyp[2]:ftyp[3]] if ftyp else b""

    # mdat payload packing order + per-file offset remap
    mdat_parts = []
    remaps = []      # per file: list of (old_start, old_end, new_start)
    new_off = len(ftyp_bytes) + 16        # 16 = large-size mdat header
    for (buf, tops, _moov, mdats) in parsed:
        spans = []
        for (_typ, hdr, s, e) in mdats:
            spans.append((s + hdr, e, new_off))
            mdat_parts.append((buf, s + hdr, e))
            new_off += e - (s + hdr)
        remaps.append(spans)

    def remap_for(i):
        spans = remaps[i]

        def fn(off):
            for (s, e, ns) in spans:
                if s <= off < e:
                    return off - s + ns
            # offset outside any mdat (rare; e.g. data in moov): keep the
            # first-span rebase so relative layout survives
            s, _e, ns = spans[0]
            return off - s + ns
        return fn

    # merge per-track tables
    tables = []
    for ti, trak in enumerate(base_traks):
        stbl = trak.find(b"mdia").find(b"minf").find(b"stbl")
        t = _TrackTables(stbl)
        t.offsets = [remap_for(0)(x) for x in t.offsets]
        tables.append(t)
    mvhd = base_moov.find(b"mvhd")
    movie_ts = _timescale(mvhd.payload, "mvhd")
    movie_dur = _duration(mvhd.payload, "mvhd")
    media_durs = []
    track_durs = []
    for trak in base_traks:
        mdhd = trak.find(b"mdia").find(b"mdhd")
        media_durs.append(_duration(mdhd.payload, "mdhd"))
        tkhd = trak.find(b"tkhd")
        track_durs.append(_duration(tkhd.payload, "tkhd") if tkhd else 0)

    for i, (_buf, _tops, moov, _mdats) in enumerate(parsed[1:], start=1):
        traks = _traks(moov)
        for ti, trak in enumerate(traks):
            mdhd = trak.find(b"mdia").find(b"mdhd")
            base_mdhd = base_traks[ti].find(b"mdia").find(b"mdhd")
            if _timescale(mdhd.payload, "mdhd") != \
                    _timescale(base_mdhd.payload, "mdhd"):
                raise IOError("media timescale mismatch between chapters")
            stbl = trak.find(b"mdia").find(b"minf").find(b"stbl")
            tables[ti].append(_TrackTables(stbl), remap_for(i))
            media_durs[ti] += _duration(mdhd.payload, "mdhd")
            tkhd = trak.find(b"tkhd")
            if tkhd is not None:
                track_durs[ti] += _duration(tkhd.payload, "tkhd")
        omvhd = moov.find(b"mvhd")
        if _timescale(omvhd.payload, "mvhd") != movie_ts:
            raise IOError("movie timescale mismatch between chapters")
        movie_dur += _duration(omvhd.payload, "mvhd")

    # patch the base moov
    mvhd.payload = _set_duration(mvhd.payload, "mvhd", movie_dur)
    for ti, trak in enumerate(base_traks):
        stbl = trak.find(b"mdia").find(b"minf").find(b"stbl")
        tables[ti].patch(stbl)
        mdhd = trak.find(b"mdia").find(b"mdhd")
        mdhd.payload = _set_duration(mdhd.payload, "mdhd", media_durs[ti])
        tkhd = trak.find(b"tkhd")
        if tkhd is not None:
            tkhd.payload = _set_duration(tkhd.payload, "tkhd", track_durs[ti])
        edts = trak.find(b"edts")
        if edts is not None:
            # drop edit lists: merged timelines start at 0 like the chapters
            trak.children.remove(edts)

    total_mdat = sum(e - s for (_b, s, e) in mdat_parts)
    CHUNK = 8 << 20
    with open(output_path, "wb") as fh:
        fh.write(ftyp_bytes)
        fh.write(struct.pack(">I4sQ", 1, b"mdat", total_mdat + 16))
        for (buf, s, e) in mdat_parts:
            while s < e:            # bounded copies, not one 4 GiB slice
                fh.write(buf[s:min(s + CHUNK, e)])
                s += CHUNK
        fh.write(base_moov.serialize())
        nbytes = fh.tell()
    for b in bufs:
        if hasattr(b, "close"):
            b.close()
    for f in files:
        f.close()
    return {"files": len(file_list), "bytes": nbytes,
            "output": os.path.abspath(output_path)}
