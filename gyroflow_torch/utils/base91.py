"""basE91 encoding (Joachim Henke's scheme, as used by the Rust base91 crate).

The reference compresses project-file gyro blobs as base91(zlib(CBOR))
(core/util.rs:44-57); this is the byte-compatible codec.
"""
from __future__ import annotations

ALPHABET = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
            "!#$%&()*+,./:;<=>?@[]^_`{|}~\"")
DECODE_TABLE = {c: i for i, c in enumerate(ALPHABET)}


def encode(data: bytes) -> str:
    b = 0
    n = 0
    out = []
    for byte in data:
        b |= byte << n
        n += 8
        if n > 13:
            v = b & 8191
            if v > 88:
                b >>= 13
                n -= 13
            else:
                v = b & 16383
                b >>= 14
                n -= 14
            out.append(ALPHABET[v % 91])
            out.append(ALPHABET[v // 91])
    if n:
        out.append(ALPHABET[b % 91])
        if n > 7 or b > 90:
            out.append(ALPHABET[b // 91])
    return "".join(out)


def decode(text: str) -> bytes:
    v = -1
    b = 0
    n = 0
    out = bytearray()
    for c in text:
        if c not in DECODE_TABLE:
            continue
        d = DECODE_TABLE[c]
        if v < 0:
            v = d
        else:
            v += d * 91
            b |= v << n
            n += 13 if (v & 8191) > 88 else 14
            while n > 7:
                out.append(b & 255)
                b >>= 8
                n -= 8
            v = -1
    if v >= 0:
        out.append((b | v << n) & 255)
    return bytes(out)
