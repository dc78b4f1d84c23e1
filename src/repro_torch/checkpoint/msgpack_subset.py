"""The part of MessagePack that checkpoints use: maps, arrays, str, bin,
int, uint, bool, nil and float64.

:func:`packb` gives the bytes ``msgpack.packb`` gives for the same object
(default options: str as str, bytes as bin, each in its shortest form;
Python floats as float64); :func:`unpackb` reads them back, str as str and
bin as a zero-copy ``memoryview``.  The header helpers let a writer stream a
large array or bin to a file piece by piece with the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

__all__ = ["packb", "pack_to", "unpackb", "array_header", "map_header", "bin_header", "BIN_MAX"]

BIN_MAX = 0xFFFFFFFF   # the largest bin (bin32) MessagePack can hold


def _sized(n: int, fix: int | None, fixmax: int, codes: tuple[tuple[int, int, str], ...],
           what: str) -> bytes:
    if fix is not None and n <= fixmax:
        return bytes([fix | n])
    for limit, code, fmt in codes:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} is too large for MessagePack (at most {codes[-1][0]})")


def array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I")), "array")


def map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I")), "map")


def bin_header(n: int) -> bytes:
    return _sized(n, None, -1, ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (BIN_MAX, 0xC6, ">I")),
                  "bin")


def _str_header(n: int) -> bytes:
    return _sized(n, 0xA0, 31, ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I")),
                  "str")


def _int(v: int) -> bytes:
    if v >= 0:
        if v <= 0x7F:
            return bytes([v])
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"), (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        if v >= -32:
            return struct.pack(">b", v)
        for limit, code, fmt in ((-(1 << 7), 0xD0, ">b"), (-(1 << 15), 0xD1, ">h"),
                                 (-(1 << 31), 0xD2, ">i"), (-(1 << 63), 0xD3, ">q")):
            if v >= limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit 64 bits")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += (_str_header(len(data)), data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        out += (bin_header(data.nbytes), data)
    elif isinstance(obj, dict):
        out.append(map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(array_header(len(obj)))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def pack_to(obj: Any, write: Callable[[Any], Any]) -> None:
    """Write ``obj`` as MessagePack through ``write`` piece by piece (bin
    payloads are passed as they are, not copied)."""
    out: list = []
    _pack(obj, out)
    for piece in out:
        write(piece)


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}   # bin
        if b in sized:
            return self.take(self.num(sized[b]))
        if b == 0xCA:
            return self.num(">f")
        if b == 0xCB:
            return self.num(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.num(ints[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.num(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.num(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self.num(">H" if b == 0xDE else ">I"))
        raise ValueError(f"MessagePack type byte 0x{b:02x} is not in the checkpoint subset")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpackb(buf) -> Any:
    """The object in ``buf`` (bytes-like); bin values are memoryviews into
    ``buf``."""
    reader = _Reader(buf)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the MessagePack object")
    return obj
