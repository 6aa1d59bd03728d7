"""gyroflow_torch's DNG reader on damaged files: only ValueError escapes.

The port's ``render/dng_seq.py`` bounds every IFD count and offset by the
file's length before it unpacks them, and checks the type of each tag value
it uses; its errors are ``DNGError``, both an IOError (as the reader's
errors always were) and a ValueError. A lossless-JPEG (Compression=7) DNG,
built as ``tests/test_telemetry_robustness.py::TestMutationFuzzDng`` builds
it but with the port's own LJPEG encoder, is mutated byte by byte and
truncated: each read either returns finite planes or raises ValueError.
"""
import struct

import numpy as np
import pytest

from gyroflow_torch.render.dng_seq import DNGError, DNGSequenceReader
from gyroflow_torch.utils import ljpeg

T_STRIP_COUNTS = 279


def _dng_blob():
    rng = np.random.default_rng(1)
    h, w = 16, 24
    cfa = rng.integers(0, 4096, (h, w)).astype(np.uint16)
    jpg = ljpeg.encode(cfa.reshape(h, w // 2, 2), precision=12)
    entries = [(254, 4, [0]), (256, 4, [w]), (257, 4, [h]), (258, 3, [12]),
               (259, 3, [7]), (262, 3, [32803]), (277, 3, [1]),
               (278, 4, [h]), (33422, 1, [0, 1, 1, 2]), (50714, 3, [0]),
               (50717, 4, [4095])]
    n = len(entries) + 2
    data_off = 8 + 2 + n * 12 + 4
    entries += [(273, 4, [data_off]), (T_STRIP_COUNTS, 4, [len(jpg)])]
    entries.sort(key=lambda x: x[0])
    out = bytearray(struct.pack("<2sHI", b"II", 42, 8))
    out += struct.pack("<H", len(entries))
    tfm = {1: "B", 3: "H", 4: "I"}
    for tag, typ, vals in entries:
        packed = struct.pack("<" + tfm[typ] * len(vals), *vals).ljust(4, b"\x00")
        out += struct.pack("<HHI", tag, typ, len(vals)) + packed
    out += struct.pack("<I", 0)
    out += jpg
    return bytes(out)


def _read(tmp_path, blob):
    """Read the file; None if it reads (with finite planes), else the
    ValueError it raised. Any other exception fails the test."""
    (tmp_path / "f_0000.dng").write_bytes(blob)
    try:
        r = DNGSequenceReader(str(tmp_path / "f_%04d.dng"))
        for _ts, planes in r:
            for pl in planes:
                assert np.isfinite(np.asarray(pl, np.float32)).all()
            break
    except ValueError as e:
        return e
    return None


def test_intact_file_reads(tmp_path):
    assert _read(tmp_path, _dng_blob()) is None


def test_mutations_raise_only_value_error(tmp_path):
    blob = _dng_blob()
    rng = np.random.default_rng(7)
    errors = 0
    for _trial in range(300):
        mutated = bytearray(blob)
        for _ in range(int(rng.integers(1, 6))):
            mutated[int(rng.integers(0, len(mutated)))] = int(rng.integers(0, 256))
        errors += _read(tmp_path, bytes(mutated)) is not None
    assert errors > 100          # most mutations damage the file


def test_truncations_raise_only_value_error(tmp_path):
    blob = _dng_blob()
    for cut in (1, 7, 9, 40, len(blob) // 4, len(blob) // 2, len(blob) - 3):
        assert _read(tmp_path, blob[:cut]) is not None


@pytest.mark.parametrize("field", ["count", "entries", "offset"])
def test_unbounded_ifd_is_refused_before_unpacking(tmp_path, field):
    """A 32-bit value count of 0xFFFFFFFF (which the reference turns into a
    ~2.7 GB format string), an entry count past the file's end and a value
    offset past it: each is a DNGError before any unpack."""
    blob = bytearray(_dng_blob())
    n = struct.unpack_from("<H", blob, 8)[0]
    strip_counts = next(10 + i * 12 for i in range(n)
                        if struct.unpack_from("<H", blob, 10 + i * 12)[0] == T_STRIP_COUNTS)
    if field == "count":
        struct.pack_into("<I", blob, strip_counts + 4, 0xFFFFFFFF)
    elif field == "entries":
        struct.pack_into("<H", blob, 8, 0xFFFF)
    else:
        struct.pack_into("<HI", blob, strip_counts + 2, 5, 2)       # 2 rationals,
        struct.pack_into("<I", blob, strip_counts + 8, len(blob))   # at the end
    err = _read(tmp_path, bytes(blob))
    assert isinstance(err, DNGError) and isinstance(err, IOError)
    assert "past the end" in str(err)
