"""A standard-library msgpack reader and writer for flax's checkpoint format.

dvc_tpu writes its checkpoints with ``flax.serialization.to_bytes``
(dvc_tpu/train/checkpoint.py:37-45, dvc_tpu/convert/vocode.py:21-34): a
msgpack map with string keys whose leaves are ndarrays.  flax packs an
ndarray as ext type 1 and a numpy scalar as ext type 3, each holding a
packed ``(shape, dtype name, C-order bytes)`` triple.  ``packb`` makes the
same bytes as ``flax.serialization.msgpack_serialize`` for a tree of dicts
with string keys, lists, tuples, numpy arrays and scalars, Python numbers,
strings, bytes and None (dicts in their insertion order); ``unpackb`` reads
what flax writes back into numpy.  Arrays above flax's 1 GiB chunk limit
are not written in chunks here and are refused.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_LEAF_BYTES = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


# --- writer ------------------------------------------------------------------

def _pack_uint(n: int, out: bytearray) -> None:
    if n < 0x80:
        out.append(n)
    elif n < 0x100:
        out += b"\xcc" + struct.pack(">B", n)
    elif n < 0x10000:
        out += b"\xcd" + struct.pack(">H", n)
    elif n < 0x100000000:
        out += b"\xce" + struct.pack(">I", n)
    else:
        out += b"\xcf" + struct.pack(">Q", n)


def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        _pack_uint(n, out)
    elif n >= -32:
        out += struct.pack(">b", n)
    elif n >= -0x80:
        out += b"\xd0" + struct.pack(">b", n)
    elif n >= -0x8000:
        out += b"\xd1" + struct.pack(">h", n)
    elif n >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", n)
    else:
        out += b"\xd3" + struct.pack(">q", n)


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A container or string header: the fix form below fix_max, else the
    first of codes (8-, 16-, 32-bit length) that holds n."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in codes:
        if n < limit:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} too large")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARR = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))
_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
_EXT = ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16), (0xc9, ">I", 1 << 32))


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not serializable")
    if a.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes is above flax's chunk limit")
    return packb((tuple(int(d) for d in a.shape), a.dtype.name,
                  np.ascontiguousarray(a).tobytes()))


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _pack_len(len(data), None, 0, _EXT, out)
    out += struct.pack(">b", code) + data


def _pack(obj: Any, out: bytearray) -> None:
    t = type(obj)  # exact types, as flax's strict_types=True packing
    if obj is None:
        out.append(0xc0)
    elif t is bool:
        out.append(0xc3 if obj else 0xc2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xa0, 32, _STR, out)
        out += b
    elif t is bytes:
        _pack_len(len(obj), None, 0, _BIN, out)
        out += obj
    elif t in (list, tuple):
        _pack_len(len(obj), 0x90, 16, _ARR, out)
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            if type(k) is not str:
                raise TypeError(f"map key {k!r} is not a string")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {t.__name__}")


def packb(obj: Any) -> bytes:
    """The msgpack bytes of ``obj`` (flax's encoding of ndarrays)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# --- reader ------------------------------------------------------------------

def _ndarray_from(data: bytes) -> np.ndarray:
    shape, name, raw = _Reader(data).read()
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


_SIMPLE = {0xc0: None, 0xc2: False, 0xc3: True}
_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
          0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
# bin 8/16/32, ext 8/16/32, str 8/16/32, array 16/32, map 16/32: the length's format
_SIZED = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I",
          0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H",
          0xdf: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self) -> Any:
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.read() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.string(c & 0x1f)
        if c in _SIMPLE:
            return _SIMPLE[c]
        if c in _FIXED:
            return self.unpack(_FIXED[c])
        if c in _SIZED:
            n = self.unpack(_SIZED[c])
            if c <= 0xc6:
                return self.take(n)
            if c <= 0xc9:
                return self.ext(n)
            if c <= 0xdb:
                return self.string(n)
            if c <= 0xdd:
                return [self.read() for _ in range(n)]
            return self.map(n)
        if c in (0xd4, 0xd5, 0xd6, 0xd7, 0xd8):
            return self.ext(1 << (c - 0xd4))
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(obj: Any) -> Any:
    """flax's chunked form of an array above its leaf limit, joined back."""
    if type(obj) is not dict:
        return obj
    if "__msgpack_chunked_array__" in obj:
        shape = [obj["shape"][str(i)] for i in range(len(obj["shape"]))]
        chunks = [obj["chunks"][str(i)] for i in range(len(obj["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in obj.items()}


def unpackb(data: bytes) -> Any:
    """Decode msgpack bytes; flax's ndarray ext becomes a numpy array
    (read-only; bfloat16 widened to float32 exactly), its scalar ext a
    numpy scalar, and its chunked arrays whole arrays.  Arrays of msgpack
    come back as lists."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return _unchunk(obj)
