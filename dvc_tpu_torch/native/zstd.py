"""Zstandard frames, CRC-32C and XXH64 for the port's orbax checkpoints.

``decompress`` binds the native decoder of ``dvc_zstd.cpp`` (RFC 8878: raw,
RLE and compressed blocks, Huffman literals, FSE sequences, the content
checksum), built into build/native/ at first use like the other engines; a
failed build raises.  The writer side needs no compressor: ``compress_raw``
emits a frame whose blocks are all raw, which every zstd decoder reads, so
a header can say ``zstd`` while the payload stays as it is.
"""

from __future__ import annotations

import ctypes
import struct

from dvc_tpu_torch.native._build import load

MAGIC = b"\x28\xb5\x2f\xfd"
BLOCK_MAX = 128 << 10

_U8P = ctypes.POINTER(ctypes.c_uint8)


class ZstdError(ValueError):
    """A malformed, truncated or corrupted zstd frame."""


def _declare(lib: ctypes.CDLL) -> None:
    lib.dvc_zstd_decompress.restype = ctypes.c_int
    lib.dvc_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_size_t),
                                        ctypes.c_char_p, ctypes.c_size_t]
    lib.dvc_zstd_free.restype = None
    lib.dvc_zstd_free.argtypes = [_U8P]
    lib.dvc_crc32c.restype = ctypes.c_uint32
    lib.dvc_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.dvc_xxh64.restype = ctypes.c_uint64
    lib.dvc_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]


def _lib() -> ctypes.CDLL:
    return load("dvc_zstd", _declare)


def decompress(data: bytes) -> bytes:
    """The content of every frame in ``data`` (skippable frames skipped);
    raises ZstdError on a malformed, truncated or corrupted frame."""
    lib = _lib()
    data = bytes(data)
    out = _U8P()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if lib.dvc_zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(n),
                               err, len(err)) != 0:
        raise ZstdError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.dvc_zstd_free(out)


def compress_raw(data: bytes) -> bytes:
    """One zstd frame holding ``data`` in raw blocks of at most 128 KiB:
    a single-segment header with the 8-byte content size, no checksum."""
    view = memoryview(bytes(data))
    parts = [MAGIC, bytes([0xE0]), struct.pack("<Q", len(view))]
    starts = range(0, len(view), BLOCK_MAX) if len(view) else [0]
    for i, start in enumerate(starts):
        size = min(BLOCK_MAX, len(view) - start)
        last = 1 if i == len(starts) - 1 else 0
        parts.append((last | (size << 3)).to_bytes(3, "little"))
        parts.append(view[start:start + size])
    return b"".join(parts)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    data = bytes(data)
    return int(_lib().dvc_crc32c(data, len(data), crc))


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    data = bytes(data)
    return int(_lib().dvc_xxh64(data, len(data), seed))
