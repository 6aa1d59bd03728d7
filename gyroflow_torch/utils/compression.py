"""base91(zlib(CBOR)) blob codec (core/util.rs:44-68)."""
from __future__ import annotations

import zlib
from typing import Any, Optional

from . import base91, cbor


def compress_to_base91(data: bytes) -> str:
    return base91.encode(zlib.compress(data, 9))


def decompress_from_base91(text: str) -> Optional[bytes]:
    if not text:
        return None
    try:
        return zlib.decompress(base91.decode(text))
    except zlib.error:
        return None


def compress_to_base91_cbor(value: Any) -> Optional[str]:
    try:
        return compress_to_base91(cbor.dumps(value))
    except TypeError:
        return None


def decompress_from_base91_cbor(text: str) -> Any:
    raw = decompress_from_base91(text)
    if raw is None:
        return None
    return cbor.loads(raw)
