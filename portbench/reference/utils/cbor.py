"""Minimal CBOR (RFC 8949) codec.

Covers the subset ciborium emits for the reference's project blobs: unsigned/
negative ints, byte/text strings, arrays, maps (int or text keys), floats
(f64; f16/f32 decode), bool/null. No external dependency needed.
"""
from __future__ import annotations

import math
import struct
from typing import Any


def _head(mt: int, val: int) -> bytes:
    if val < 24:
        return bytes([(mt << 5) | val])
    if val < 0x100:
        return bytes([(mt << 5) | 24, val])
    if val < 0x10000:
        return bytes([(mt << 5) | 25]) + struct.pack(">H", val)
    if val < 0x100000000:
        return bytes([(mt << 5) | 26]) + struct.pack(">I", val)
    return bytes([(mt << 5) | 27]) + struct.pack(">Q", val)


def dumps(obj: Any) -> bytes:
    out = bytearray()
    _enc(obj, out)
    return bytes(out)


def _enc(o: Any, out: bytearray):
    if o is None:
        out.append(0xF6)
    elif o is True:
        out.append(0xF5)
    elif o is False:
        out.append(0xF4)
    elif isinstance(o, int):
        if o >= 0:
            out += _head(0, o)
        else:
            out += _head(1, -1 - o)
    elif isinstance(o, float):
        out.append(0xFB)
        out += struct.pack(">d", o)
    elif isinstance(o, bytes):
        out += _head(2, len(o))
        out += o
    elif isinstance(o, str):
        b = o.encode("utf-8")
        out += _head(3, len(b))
        out += b
    elif isinstance(o, (list, tuple)):
        out += _head(4, len(o))
        for v in o:
            _enc(v, out)
    elif isinstance(o, dict):
        out += _head(5, len(o))
        for k, v in o.items():
            _enc(k, out)
            _enc(v, out)
    else:
        import numpy as np
        if isinstance(o, np.integer):
            _enc(int(o), out)
        elif isinstance(o, np.floating):
            _enc(float(o), out)
        elif isinstance(o, np.ndarray):
            _enc(o.tolist(), out)
        else:
            raise TypeError(f"CBOR: unsupported type {type(o)}")


def loads(data: bytes) -> Any:
    v, i = _dec(data, 0)
    return v


def _dec(d: bytes, i: int):
    ib = d[i]
    mt = ib >> 5
    ai = ib & 31
    i += 1
    val = None
    if mt != 7:  # major type 7 interprets `ai` itself (floats/simple values)
        if ai < 24:
            val = ai
        elif ai == 24:
            val = d[i]; i += 1
        elif ai == 25:
            val = struct.unpack(">H", d[i:i + 2])[0]; i += 2
        elif ai == 26:
            val = struct.unpack(">I", d[i:i + 4])[0]; i += 4
        elif ai == 27:
            val = struct.unpack(">Q", d[i:i + 8])[0]; i += 8
        elif ai == 31:
            val = None  # indefinite length
        else:
            raise ValueError(f"CBOR: bad additional info {ai}")

    if mt == 0:
        return val, i
    if mt == 1:
        return -1 - val, i
    if mt == 2:
        if val is None:
            chunks = bytearray()
            while d[i] != 0xFF:
                c, i = _dec(d, i)
                chunks += c
            return bytes(chunks), i + 1
        return d[i:i + val], i + val
    if mt == 3:
        if val is None:
            s = ""
            while d[i] != 0xFF:
                c, i = _dec(d, i)
                s += c
            return s, i + 1
        return d[i:i + val].decode("utf-8"), i + val
    if mt == 4:
        arr = []
        if val is None:
            while d[i] != 0xFF:
                v, i = _dec(d, i)
                arr.append(v)
            return arr, i + 1
        for _ in range(val):
            v, i = _dec(d, i)
            arr.append(v)
        return arr, i
    if mt == 5:
        m = {}
        if val is None:
            while d[i] != 0xFF:
                k, i = _dec(d, i)
                v, i = _dec(d, i)
                m[k] = v
            return m, i + 1
        for _ in range(val):
            k, i = _dec(d, i)
            v, i = _dec(d, i)
            m[k] = v
        return m, i
    if mt == 6:  # tag: decode and ignore the tag
        return _dec(d, i)
    if mt == 7:
        if ai == 20:
            return False, i
        if ai == 21:
            return True, i
        if ai == 22 or ai == 23:
            return None, i
        if ai == 25:  # f16
            h = struct.unpack(">H", d[i:i + 2])[0]
            return _half_to_float(h), i + 2
        if ai == 26:
            return struct.unpack(">f", d[i:i + 4])[0], i + 4
        if ai == 27:
            return struct.unpack(">d", d[i:i + 8])[0], i + 8
        raise ValueError(f"CBOR: bad simple value {ai}")
    raise ValueError(f"CBOR: bad major type {mt}")


def _half_to_float(h: int) -> float:
    s = (h >> 15) & 1
    e = (h >> 10) & 31
    f = h & 1023
    if e == 0:
        v = f * 2.0 ** -24
    elif e == 31:
        v = math.inf if f == 0 else math.nan
    else:
        v = (f + 1024) * 2.0 ** (e - 25)
    return -v if s else v
