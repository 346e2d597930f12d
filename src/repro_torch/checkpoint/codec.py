"""A small msgpack codec: the part of the format the checkpoint files use
(``repro_torch.checkpoint``), so the port needs no ``msgpack`` package.

Encoder: fixmap/map32 headers, str (fixstr, str8, str16, str32), the
positive (fixint, uint8..uint64) and negative (fixint, int8..int64) int
forms, bin32 and array32.  ``pack`` encodes a tree of those; the header
functions let a writer stream a large bin's bytes after its header.

Decoder (``unpack``): nil, bool, every int width, float32/64,
fixstr/str8/16/32, bin8/16/32, fixarray/array16/32 and fixmap/map16/32 --
what ``msgpack.packb(..., use_bin_type=True)`` writes for the v1 and v2
checkpoint files.  A bin decodes to a ``memoryview`` slice of the input
(no copy), so a reader can decode a memory-mapped file without reading it.
Any malformed or truncated input raises ``DecodeError``.
"""
from __future__ import annotations

import struct
from typing import Any

BIN32_MAX = 0xFFFFFFFF          # the most bytes one bin32 holds


class DecodeError(ValueError):
    """The bytes are not one well-formed msgpack object."""


def pack_int(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return bytes((n,))
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", (1 << 64) - 1)):
            if n <= top:
                return bytes((tag,)) + struct.pack(fmt, n)
        raise ValueError(f"int {n} does not fit msgpack's uint64")
    if n >= -32:
        return struct.pack(">b", n)
    for tag, fmt, bits in ((0xD0, ">b", 8), (0xD1, ">h", 16), (0xD2, ">i", 32),
                           (0xD3, ">q", 64)):
        if n >= -(1 << (bits - 1)):
            return bytes((tag,)) + struct.pack(fmt, n)
    raise ValueError(f"int {n} does not fit msgpack's int64")


def pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        head = bytes((0xA0 | n,))
    elif n <= 0xFF:
        head = b"\xd9" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        head = b"\xda" + struct.pack(">H", n)
    else:
        head = b"\xdb" + struct.pack(">I", n)
    return head + b


def bin_header(n: int) -> bytes:
    if not 0 <= n <= BIN32_MAX:
        raise ValueError(f"{n} bytes do not fit one msgpack bin32 (at most {BIN32_MAX})")
    return b"\xc6" + struct.pack(">I", n)


def array_header(n: int) -> bytes:
    return b"\xdd" + struct.pack(">I", n)


def map_header(n: int) -> bytes:
    return bytes((0x80 | n,)) if n < 16 else b"\xdf" + struct.pack(">I", n)


def pack(obj: Any) -> bytes:
    """One msgpack object: dicts, lists/tuples, str, int and bytes."""
    if isinstance(obj, bool):
        raise TypeError("the checkpoint codec writes no bools")
    if isinstance(obj, int):
        return pack_int(obj)
    if isinstance(obj, str):
        return pack_str(obj)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bin_header(len(obj)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return array_header(len(obj)) + b"".join(pack(x) for x in obj)
    if isinstance(obj, dict):
        return map_header(len(obj)) + b"".join(pack(k) + pack(v) for k, v in obj.items())
    raise TypeError(f"the checkpoint codec cannot pack {type(obj).__name__}")


class _Reader:
    def __init__(self, buf):
        self.mv = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.mv):
            raise DecodeError(f"truncated: {n} bytes wanted at offset {self.pos}, "
                              f"{len(self.mv) - self.pos} left")
        out = self.mv[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def str_(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError(f"invalid utf-8 in a str: {e}") from None

    def count(self, n: int, least: int) -> int:
        """``n`` elements of at least ``least`` bytes each must fit what is
        left (a damaged header cannot start a loop over billions)."""
        if n * least > len(self.mv) - self.pos:
            raise DecodeError(f"truncated: {n} elements cannot fit the "
                              f"{len(self.mv) - self.pos} bytes left")
        return n

    def array(self, n: int) -> list:
        return [self.read() for _ in range(self.count(n, 1))]

    def map_(self, n: int) -> dict:
        self.count(n, 2)
        out = {}
        for _ in range(n):
            k = self.read()
            try:
                out[k] = self.read()
            except TypeError:
                raise DecodeError(f"unhashable map key {type(k).__name__}") from None
        return out

    def read(self):
        b = self.num(">B", 1)
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return self.map_(b & 0x0F)
        if b & 0xF0 == 0x90:
            return self.array(b & 0x0F)
        if b & 0xE0 == 0xA0:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
                0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
                0xCA: (">f", 4), 0xCB: (">d", 8)}
        if b in ints:
            return self.num(*ints[b])
        sizes = {0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4),
                 0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4),
                 0xDC: (">H", 2), 0xDD: (">I", 4), 0xDE: (">H", 2), 0xDF: (">I", 4)}
        if b not in sizes:
            raise DecodeError(f"unsupported msgpack type byte {b:#04x} at offset "
                              f"{self.pos - 1}")
        n = self.num(*sizes[b])
        if b <= 0xC6:
            return self.take(n)
        if b <= 0xDB:
            return self.str_(n)
        return self.array(n) if b <= 0xDD else self.map_(n)


def unpack(buf) -> Any:
    """The one msgpack object that fills ``buf`` (bytes, bytearray, mmap or
    memoryview); bins come back as memoryview slices of ``buf``."""
    r = _Reader(buf)
    obj = r.read()
    if r.pos != len(r.mv):
        raise DecodeError(f"{len(r.mv) - r.pos} trailing bytes after the object")
    return obj
