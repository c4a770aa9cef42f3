"""The subset of msgpack that a checkpoint document holds, in pure Python.

``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
for dict, list, tuple, str, bytes, int, float, bool and None: the
smallest integer format (positive and negative fixint, uint8-64 for
values >= 0, int8-64 below), fixstr/str8/16/32 and bin8/16/32 by byte
length, fixmap/map16/32 and fixarray/array16/32 by entry count, float64
for every float, dict entries in insertion order. ``unpackb(data)``
reads those formats (and float32) back: str as str, bin as bytes, arrays
as lists; any other format (ext types, the reserved byte) and trailing
bytes raise ``ValueError``.

A bin payload is joined as one slice, never copied a byte at a time, so
a leaf of megabytes costs one copy each way.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

_INT_FORMATS = (
    # (lo, hi inclusive, header byte, struct format) for values >= 0
    (0x80, 0xFF, 0xCC, ">B"),
    (0x100, 0xFFFF, 0xCD, ">H"),
    (0x10000, 0xFFFFFFFF, 0xCE, ">I"),
    (0x100000000, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
)
_NEG_FORMATS = (
    # (lo inclusive, header byte, struct format) for values < -32
    (-0x80, 0xD0, ">b"),
    (-0x8000, 0xD1, ">h"),
    (-0x80000000, 0xD2, ">i"),
    (-0x8000000000000000, 0xD3, ">q"),
)


def _len_header(n: int, fix_base: int, fix_max: int, h8, h16: int, h32: int) -> bytes:
    """Length header: the fix form up to ``fix_max``, else 8 (where the
    type has it), 16 or 32 bits."""
    if n <= fix_max:
        return bytes((fix_base | n,))
    if h8 is not None and n <= 0xFF:
        return bytes((h8, n))
    if n <= 0xFFFF:
        return struct.pack(">BH", h16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", h32, n)
    raise ValueError(f"msgpack length {n} exceeds 2**32 - 1")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for _, hi, head, fmt in _INT_FORMATS:
            if v <= hi:
                return bytes((head,)) + struct.pack(fmt, v)
    else:
        for lo, head, fmt in _NEG_FORMATS:
            if v >= lo:
                return bytes((head,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(int(obj)))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_len_header(len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj) if not isinstance(obj, bytes) else obj
        out.append(_len_header(len(raw), 0, -1, 0xC4, 0xC5, 0xC6))
        out.append(raw)
    elif isinstance(obj, dict):
        out.append(_len_header(len(obj), 0x80, 15, None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_len_header(len(obj), 0x90, 15, None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the document's types."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------- decoding

# header byte -> (struct format, byte count) of fixed-width scalars
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# header byte -> (kind, struct format of the length, its byte count)
_SIZED = {
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    end = pos + n
    if end > len(buf):
        raise ValueError("msgpack data ends inside an object")
    return buf[pos:end], end


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    raw, pos = _take(buf, pos, 1)
    head = raw[0]
    if head <= 0x7F:
        return head, pos
    if head >= 0xE0:
        return head - 0x100, pos
    if 0x80 <= head <= 0x8F:
        kind, n = "map", head & 0x0F
    elif 0x90 <= head <= 0x9F:
        kind, n = "array", head & 0x0F
    elif 0xA0 <= head <= 0xBF:
        kind, n = "str", head & 0x1F
    elif head == 0xC0:
        return None, pos
    elif head == 0xC2:
        return False, pos
    elif head == 0xC3:
        return True, pos
    elif head in _SCALARS:
        fmt, size = _SCALARS[head]
        raw, pos = _take(buf, pos, size)
        return struct.unpack(fmt, raw)[0], pos
    elif head in _SIZED:
        kind, fmt, size = _SIZED[head]
        raw, pos = _take(buf, pos, size)
        n = struct.unpack(fmt, raw)[0]
    else:
        raise ValueError(f"msgpack format 0x{head:02x} is not part of a checkpoint document")
    if kind == "bin":
        raw, pos = _take(buf, pos, n)
        return raw.tobytes(), pos
    if kind == "str":
        raw, pos = _take(buf, pos, n)
        return str(raw, "utf-8"), pos
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the document's types."""
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes of extra data after the msgpack object")
    return obj
