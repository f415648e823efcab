"""An OCDBT key-value store, read and written from the bytes.

OCDBT is tensorstore's copy-on-write B-tree, the store under dvc_tpu's
orbax checkpoints (``use_ocdbt``).  A store is a directory holding
``manifest.ocdbt`` and data files under ``d/``; orbax gives each process
its own store under ``ocdbt.process_<i>/`` and then writes a root manifest
and a root B-tree whose data-file table points into those directories.

Every manifest and B-tree node is a file region of the form

    magic (uint32 big-endian)  length (uint64, the region's bytes)
    version (varint, 0)  compression (varint: 0 none, 1 zstd)
    body (zstd frame when compressed)  crc32c (uint32, of all before it)

with magic ``0c db 3a 2a`` for a manifest and ``0c db 20 de`` for a node.
Integers in a body are little-endian; "varint" is LEB128.

Manifest body: the config (uuid[16], manifest kind, max inline value bytes,
max decoded node bytes, version-tree arity log2 (uint8), compression
method, and for zstd its level as int32), a data-file table, the newest
versions inline (count, then column by column: generation, root height
(uint8), root data file, offset, length, key count, tree bytes, indirect
value bytes, commit time (uint64 ns)), then references to version-tree
nodes holding older versions, which a reader of the newest state skips.

Data-file table: count, the shared prefix length of each path with the
one before it (from the second on), each path's suffix length, each
path's base-path length, then the suffixes.  A path is relative to the
store's directory; the root store's tables name ``ocdbt.process_<i>/d/..``
with ``ocdbt.process_<i>/`` as the base path.

Node body: height (uint8), a data-file table, the entry count, the keys
(shared prefix lengths from the second on, suffix lengths, and in an
interior node the subtree's common prefix lengths; then the suffixes),
then for a leaf each value's length and kind (0 inline, 1 indirect), the
data file and offset of each indirect value, and the inline values; for
an interior node each child's data file, offset, length, key count, tree
bytes and indirect value bytes.  A child's keys are stored without the
common prefix its parent entry names.

The layout was worked out from stores that tensorstore writes; the tests
hold this module to tensorstore in both directions.
"""

from __future__ import annotations

import os
import struct
import time
import uuid as uuid_lib
from dataclasses import dataclass

from dvc_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
MAX_INLINE_VALUE_BYTES = 1024          # what orbax's stores use
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
COMPRESSION_ZSTD = 1


class OcdbtError(ValueError):
    """A malformed or inconsistent OCDBT store."""


# --- encoding helpers -------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        shift = value = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(ns) -> bytes:
    return b"".join(_varint(n) for n in ns)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node region, its header and checksum
    checked."""
    if len(blob) < 18:
        raise OcdbtError(f"{what}: truncated")
    got_magic, length = struct.unpack(">I", blob[:4])[0], struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: bad magic {got_magic:08x}")
    if length != len(blob):
        raise OcdbtError(f"{what}: length {length} != {len(blob)}")
    if zstd.crc32c(blob[:-4]) != struct.unpack("<I", blob[-4:])[0]:
        raise OcdbtError(f"{what}: checksum mismatch")
    r = _Reader(blob[:-4], what)
    r.take(12)
    if r.varint() != 0:
        raise OcdbtError(f"{what}: unknown format version")
    compression = r.varint()
    body = blob[r.pos:-4]
    if compression == 0:
        return body
    if compression == COMPRESSION_ZSTD:
        return zstd.decompress(body)
    raise OcdbtError(f"{what}: unknown compression {compression}")


def _frame(body: bytes, magic: int) -> bytes:
    """A region around ``body``: zstd-framed (raw blocks), compression 1,
    as tensorstore's stores say."""
    payload = _varint(0) + _varint(COMPRESSION_ZSTD) + zstd.compress_raw(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    blob = head + payload
    return blob + struct.pack("<I", zstd.crc32c(blob))


# --- data-file tables ---------------------------------------------------------

@dataclass(frozen=True)
class DataFile:
    base_path: str   # e.g. "ocdbt.process_0/" in a root store, "" in a process store
    relative: str    # e.g. "d/<hex>"

    @property
    def path(self) -> str:
        return self.base_path + self.relative


def _read_file_table(r: _Reader) -> list[DataFile]:
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError(f"{r.what}: bad data-file prefix")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(full):
            raise OcdbtError(f"{r.what}: bad base path length")
        text = full.decode()
        files.append(DataFile(text[:base[i]], text[base[i]:]))
        prev = full
    return files


def _write_file_table(files: list[DataFile]) -> bytes:
    paths = [f.path.encode() for f in files]
    prefix = [_common_prefix(paths[i - 1], paths[i]) for i in range(1, len(paths))]
    suffixes = [p[k:] for p, k in zip(paths, [0] + prefix)]
    return (_varint(len(files)) + _varints(prefix) + _varints(len(s) for s in suffixes)
            + _varints(len(f.base_path.encode()) for f in files) + b"".join(suffixes))


# --- manifest -------------------------------------------------------------------

@dataclass(frozen=True)
class NodeRef:
    file: DataFile
    offset: int
    length: int
    height: int
    num_keys: int
    tree_bytes: int
    indirect_bytes: int


def read_manifest(store: str) -> NodeRef | None:
    """The root of the newest version in ``store``'s manifest, or None for
    an empty tree."""
    path = os.path.join(store, MANIFEST)
    with open(path, "rb") as f:
        r = _Reader(_unframe(f.read(), MANIFEST_MAGIC, path), path)
    r.take(16)                                   # uuid
    if r.varint() != 0:
        raise OcdbtError(f"{path}: only single-file manifests are read")
    r.varint(); r.varint(); r.u8()               # inline limit, node limit, arity
    if r.varint() == COMPRESSION_ZSTD:
        r.take(4)                                # zstd level
    files = _read_file_table(r)
    n = r.varint()
    if n == 0:
        raise OcdbtError(f"{path}: no versions")
    gens = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    cols = [r.varints(n) for _ in range(6)]      # file, offset, length, keys, bytes, indirect
    r.take(8 * n)                                # commit times
    i = max(range(n), key=gens.__getitem__)
    file_id, offset, length, keys, tree_bytes, indirect = (c[i] for c in cols)
    if length == 0:
        return None
    if file_id >= len(files):
        raise OcdbtError(f"{path}: root names data file {file_id} of {len(files)}")
    return NodeRef(files[file_id], offset, length, heights[i], keys, tree_bytes, indirect)


def _write_manifest(store: str, root: NodeRef, store_uuid: bytes) -> None:
    config = (store_uuid + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(COMPRESSION_ZSTD) + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + bytes([root.height]) + _varint(0)
               + _varint(root.offset) + _varint(root.length) + _varint(root.num_keys)
               + _varint(root.tree_bytes) + _varint(root.indirect_bytes)
               + struct.pack("<Q", time.time_ns()))
    body = config + _write_file_table([root.file]) + version + _varint(0)
    _write_atomic(os.path.join(store, MANIFEST), _frame(body, MANIFEST_MAGIC))


# --- B-tree nodes ---------------------------------------------------------------

@dataclass(frozen=True)
class Value:
    """A leaf value: inline bytes, or a region of a data file."""
    inline: bytes | None = None
    file: DataFile | None = None
    offset: int = 0
    length: int = 0


def _read_node(store: str, ref: NodeRef, prefix: bytes, out: dict[bytes, Value]) -> None:
    path = os.path.join(store, ref.file.path)
    with open(path, "rb") as f:
        f.seek(ref.offset)
        blob = f.read(ref.length)
    what = f"{path}@{ref.offset}"
    r = _Reader(_unframe(blob, NODE_MAGIC, what), what)
    height = r.u8()
    if height != ref.height:
        raise OcdbtError(f"{what}: height {height}, expected {ref.height}")
    files = _read_file_table(r)
    n = r.varint()
    kprefix = [0] + r.varints(max(n - 1, 0))
    ksuffix = r.varints(n)
    common = r.varints(n) if height > 0 else None
    keys, prev = [], b""
    for i in range(n):
        if kprefix[i] > len(prev):
            raise OcdbtError(f"{what}: bad key prefix")
        prev = prev[:kprefix[i]] + r.take(ksuffix[i])
        keys.append(prev)

    def file_of(i):
        if i >= len(files):
            raise OcdbtError(f"{what}: data file {i} of {len(files)}")
        return files[i]

    if height == 0:
        lengths = r.varints(n)
        kinds = [r.varint() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{what}: unknown value kind")
        ids = r.varints(len(indirect))
        offsets = r.varints(len(indirect))
        where = dict(zip(indirect, zip(ids, offsets)))
        for i in range(n):
            if kinds[i] == 0:
                out[prefix + keys[i]] = Value(inline=r.take(lengths[i]))
            else:
                fid, off = where[i]
                out[prefix + keys[i]] = Value(file=file_of(fid), offset=off, length=lengths[i])
        return
    cols = [r.varints(n) for _ in range(6)]      # file, offset, length, keys, bytes, indirect
    for i in range(n):
        if common[i] > len(keys[i]):
            raise OcdbtError(f"{what}: bad subtree prefix")
        fid, off, length, nk, tb, ib = (c[i] for c in cols)
        child = NodeRef(file_of(fid), off, length, height - 1, nk, tb, ib)
        _read_node(store, child, prefix + keys[i][:common[i]], out)


def read_entries(store: str) -> dict[bytes, Value]:
    """Every key of ``store``'s newest version with where its value is."""
    root = read_manifest(store)
    out: dict[bytes, Value] = {}
    if root is not None:
        _read_node(store, root, b"", out)
    return out


def read_value(store: str, value: Value) -> bytes:
    if value.inline is not None:
        return value.inline
    path = os.path.join(store, value.file.path)
    with open(path, "rb") as f:
        f.seek(value.offset)
        data = f.read(value.length)
    if len(data) != value.length:
        raise OcdbtError(f"{path}: value at {value.offset} truncated")
    return data


def read_store(store: str) -> dict[bytes, bytes]:
    """Every key and value of ``store``'s newest version."""
    return {k: read_value(store, v) for k, v in read_entries(store).items()}


def _leaf(entries: dict[bytes, Value]) -> tuple[bytes, int]:
    """A leaf node over ``entries`` (sorted by key) and its indirect bytes."""
    keys = sorted(entries)
    files: list[DataFile] = []
    for k in keys:
        f = entries[k].file
        if entries[k].inline is None and f not in files:
            files.append(f)
    files.sort(key=lambda f: f.path)
    prefix = [_common_prefix(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffixes = [k[p:] for k, p in zip(keys, [0] + prefix)]
    vals = [entries[k] for k in keys]
    indirect = [v for v in vals if v.inline is None]
    body = (bytes([0]) + _write_file_table(files) + _varint(len(keys)) + _varints(prefix)
            + _varints(len(s) for s in suffixes) + b"".join(suffixes)
            + _varints(len(v.inline) if v.inline is not None else v.length for v in vals)
            + _varints(0 if v.inline is not None else 1 for v in vals)
            + _varints(files.index(v.file) for v in indirect)
            + _varints(v.offset for v in indirect)
            + b"".join(v.inline for v in vals if v.inline is not None))
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise OcdbtError(f"leaf of {len(body)} bytes exceeds the store's node limit")
    return _frame(body, NODE_MAGIC), sum(v.length for v in indirect)


def _write_atomic(path: str, data) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_tree(store: str, entries: dict[bytes, Value]) -> None:
    """The leaf over ``entries`` in a new data file and a manifest naming it."""
    node, indirect = _leaf(entries)
    node_file = DataFile("", f"d/{uuid_lib.uuid4().hex}")
    os.makedirs(os.path.join(store, "d"), exist_ok=True)
    _write_atomic(os.path.join(store, node_file.path), node)
    root = NodeRef(node_file, 0, len(node), 0, len(entries), len(node), indirect)
    _write_manifest(store, root, uuid_lib.uuid4().bytes)


def process_dir(rank: int) -> str:
    return f"ocdbt.process_{rank}"


def write_process_store(root: str, rank: int, items: dict[bytes, bytes]) -> None:
    """Rank ``rank``'s store under ``root/ocdbt.process_<rank>/``: values
    above the inline limit go, in key order, into one data file."""
    store = os.path.join(root, process_dir(rank))
    os.makedirs(os.path.join(store, "d"), exist_ok=True)
    values_file = DataFile("", f"d/{uuid_lib.uuid4().hex}")
    entries: dict[bytes, Value] = {}
    with open(os.path.join(store, values_file.path), "wb") as f:
        offset = 0
        for key in sorted(items):
            data = items[key]
            if len(data) <= MAX_INLINE_VALUE_BYTES:
                entries[key] = Value(inline=bytes(data))
            else:
                f.write(data)
                entries[key] = Value(file=values_file, offset=offset, length=len(data))
                offset += len(data)
    _write_tree(store, entries)


def write_root(root: str, ranks: list[int]) -> None:
    """The root manifest and B-tree over the process stores of ``ranks``,
    their data files named from the root, as orbax merges them."""
    merged: dict[bytes, Value] = {}
    for rank in ranks:
        sub = process_dir(rank)
        for key, v in read_entries(os.path.join(root, sub)).items():
            if key in merged:
                raise OcdbtError(f"key {key!r} written by two processes")
            if v.inline is None:
                v = Value(file=DataFile(f"{sub}/{v.file.base_path}", v.file.relative),
                          offset=v.offset, length=v.length)
            merged[key] = v
    _write_tree(root, merged)
