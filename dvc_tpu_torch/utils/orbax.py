"""dvc_tpu's orbax checkpoints, read and written without orbax.

dvc_tpu's ``--checkpoint-format orbax`` (dvc_tpu/train/checkpoint.py:48-60)
saves the TrainState with ``orbax.checkpoint.StandardCheckpointer`` into a
``{run_name}_{epoch}.orbax/`` directory:

  * ``_METADATA`` (JSON): ``tree_metadata`` keyed by the repr of each
    leaf's path tuple, with ``key_metadata`` (each key and its type: 1 for
    a sequence index, 2 for a dict key) and ``value_metadata``
    (``value_type`` "jax.Array" with the chunk shape as ``write_shape``, or
    an empty container with ``skip_deserialize``);
  * ``_CHECKPOINT_METADATA``, ``_sharding`` (base64 of each leaf's dotted
    name -> a JSON sharding) and ``array_metadatas/process_<i>``;
  * the arrays as zarr v2 in an OCDBT store (``utils/ocdbt.py``): for the
    leaf named ``a.b.c``, the key ``a.b.c/.zarray`` holds the array's
    record and ``a.b.c/<i.j...>`` each chunk, C order, a zstd frame.
    dvc_tpu's chunks are its shards, so the grid follows the sharding.

``read_orbax_state`` returns the tree that ``checkpoint.read_train_state``
returns for the .msgpack of the same state (numpy leaves, tuples as dicts
keyed "0", "1", ...; bfloat16 widened to float32 exactly).
``write_orbax_state`` writes one process's whole tree; under a process
group each rank calls ``write_orbax_shards`` with the chunks it holds,
then rank 0 calls ``finish_orbax_state``, which writes the JSON files and
the root manifest over every rank's store (dvc_tpu's "each process writes
its own shards").  The chunk payloads are zstd frames of raw blocks
(``native/zstd.compress_raw``), so every record says what dvc_tpu's says.
"""

from __future__ import annotations

import base64
import itertools
import json
import math
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from dvc_tpu_torch.native import zstd
from dvc_tpu_torch.utils import ocdbt

HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
# every leaf restores onto device 0 of the reader's platform when the
# reader passes no shardings of its own
_SHARDING = json.dumps({"sharding_type": "NamedSharding", "shape": [1],
                        "axis_names": ["device"], "partition_spec": [],
                        "device_mesh": {"mesh": [{"id": 0}]}})


@dataclass(frozen=True)
class Leaf:
    """One leaf of the tree: an array (shape, zarr dtype, chunk shape), or
    an empty container (``shape`` None)."""
    path: tuple[str, ...]
    shape: tuple[int, ...] | None = None
    dtype: str | None = None
    chunks: tuple[int, ...] | None = None

    @property
    def name(self) -> str:
        return ".".join(self.path)

    def grid(self) -> list[tuple[int, ...]]:
        return list(itertools.product(*(range(math.ceil(s / c) if s else 0)
                                        for s, c in zip(self.shape, self.chunks))))


def _zarr_dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16"
        x = x.detach().cpu().numpy()
    return np.asarray(x).dtype.str.replace("=", "<")


def _host(x) -> np.ndarray:
    """An array leaf as numpy; bfloat16 as its uint16 bit patterns."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def leaves_of(tree: dict, chunks: dict[tuple[str, ...], tuple[int, ...]] | None = None,
              prefix: tuple[str, ...] = ()) -> list[Leaf]:
    """The leaves of a nested dict of arrays in order; ``chunks`` maps a
    leaf's path to its chunk shape (default: the whole array)."""
    out = []
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, dict):
            out += leaves_of(v, chunks, path) if v else [Leaf(path)]
        else:
            shape = tuple(_host(v).shape)
            out.append(Leaf(path, shape, _zarr_dtype(v), tuple((chunks or {}).get(path, shape))))
    return out


def _key_metadata(leaf: Leaf, seq_prefixes: set) -> list[dict]:
    return [{"key": k, "key_type": 1 if leaf.path[:i] in seq_prefixes else 2}
            for i, k in enumerate(leaf.path)]


def _zarray(leaf: Leaf) -> bytes:
    record = {"chunks": list(leaf.chunks), "compressor": {"id": "zstd", "level": 1},
              "dimension_separator": ".", "dtype": leaf.dtype, "fill_value": None,
              "filters": None, "order": "C", "shape": list(leaf.shape), "zarr_format": 2}
    return json.dumps(record, separators=(",", ":"), sort_keys=True).encode()


def _chunk_key(leaf: Leaf, index: tuple[int, ...]) -> bytes:
    return f"{leaf.name}/{'.'.join(map(str, index)) if index else '0'}".encode()


def _chunk_of(x: np.ndarray, leaf: Leaf, index: tuple[int, ...]) -> np.ndarray:
    """The chunk ``index`` of the whole array ``x``."""
    return x[tuple(slice(i * c, (i + 1) * c) for i, c in zip(index, leaf.chunks))]


def _encode_chunk(leaf: Leaf, block) -> bytes:
    """A chunk as zarr stores it: the full chunk shape (edge chunks padded
    with zeros), C order, in a zstd frame."""
    block = _host(block)
    full = np.zeros(leaf.chunks, block.dtype)
    full[tuple(slice(0, s) for s in block.shape)] = block
    return zstd.compress_raw(np.ascontiguousarray(full).tobytes())


def write_orbax_shards(path: str, rank: int, leaves: list[Leaf],
                       held: dict[tuple[str, ...], dict[tuple[int, ...], Any]]) -> None:
    """Rank ``rank``'s part of a checkpoint under ``path``: the chunks it
    holds (``held[leaf path][chunk index]``, each the chunk's block of the
    array) in its own ``ocdbt.process_<rank>/`` store, and its
    ``array_metadatas`` file; rank 0 also stores every ``.zarray``."""
    by_path = {leaf.path: leaf for leaf in leaves}
    items = {}
    if rank == 0:
        items.update({f"{leaf.name}/.zarray".encode(): _zarray(leaf)
                      for leaf in leaves if leaf.shape is not None})
    for p, blocks in held.items():
        leaf = by_path[p]
        for index, block in blocks.items():
            items[_chunk_key(leaf, index)] = _encode_chunk(leaf, block)
    ocdbt.write_process_store(path, rank, items)
    os.makedirs(os.path.join(path, "array_metadatas"), exist_ok=True)
    metas = [{"array_metadata": {"param_name": leaf.name, "write_shape": list(leaf.chunks),
                                 "chunk_shape": list(leaf.chunks), "ext_metadata": None}}
             for leaf in sorted(leaves, key=lambda leaf: leaf.name) if leaf.shape is not None]
    _write_json(os.path.join(path, "array_metadatas", f"process_{rank}"),
                {"array_metadatas": metas})


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def finish_orbax_state(path: str, leaves: list[Leaf], ranks: list[int],
                       init_ns: int | None = None) -> None:
    """Rank 0, after every rank has written its shards: the root OCDBT
    store over ``ranks`` and the checkpoint's JSON files."""
    ocdbt.write_root(path, ranks)
    kids: dict[tuple[str, ...], set] = {}
    for leaf in leaves:
        for i in range(len(leaf.path)):
            kids.setdefault(leaf.path[:i], set()).add(leaf.path[i])
    # a node whose children are "0", "1", ... is a tuple
    seq = {head for head, ks in kids.items() if ks == {str(j) for j in range(len(ks))}}
    tree_meta = {}
    for leaf in leaves:
        if leaf.shape is None:
            kind = "None" if leaf.path[:-1] in seq else "Dict"
            value = {"value_type": kind, "skip_deserialize": True}
        else:
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(leaf.chunks)}
        tree_meta[repr(leaf.path)] = {"key_metadata": _key_metadata(leaf, seq),
                                      "value_metadata": value}
    _write_json(os.path.join(path, "_METADATA"),
                {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                 "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    with open(os.path.join(path, "_sharding"), "w") as f:
        json.dump({base64.b64encode(leaf.name.encode()).decode(): _SHARDING
                   for leaf in leaves if leaf.shape is not None}, f, separators=(",", ":"))
    now = time.time_ns()
    _write_json(os.path.join(path, "_CHECKPOINT_METADATA"),
                {"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                 "init_timestamp_nsecs": init_ns or now, "commit_timestamp_nsecs": now,
                 "custom_metadata": {}})


def write_orbax_state(path: str, tree: dict,
                      chunks: dict[tuple[str, ...], tuple[int, ...]] | None = None) -> str:
    """One process's whole ``tree`` (nested dicts of numpy arrays or torch
    tensors) as an orbax checkpoint at ``path``; ``chunks`` maps a leaf's
    path to its chunk shape (any grid; default one chunk a leaf)."""
    init = time.time_ns()
    os.makedirs(path, exist_ok=True)
    leaves = leaves_of(tree, chunks)
    flat = {}

    def walk(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (str(k),))
            else:
                flat[prefix + (str(k),)] = _host(v)
    walk(tree)
    held = {leaf.path: {i: _chunk_of(flat[leaf.path], leaf, i) for i in leaf.grid()}
            for leaf in leaves if leaf.shape is not None}
    write_orbax_shards(path, 0, leaves, held)
    finish_orbax_state(path, leaves, [0], init)
    return path


def _decode_chunk(record: dict, data: bytes, dtype, chunk_shape) -> np.ndarray:
    comp = record.get("compressor")
    if comp is not None:
        if comp.get("id") != "zstd":
            raise ValueError(f"unsupported zarr compressor {comp}")
        data = zstd.decompress(data)
    if record.get("filters"):
        raise ValueError(f"unsupported zarr filters {record['filters']}")
    arr = np.frombuffer(data, dtype)
    if arr.size != math.prod(chunk_shape):
        raise ValueError(f"chunk of {arr.size} elements, expected {chunk_shape}")
    return arr.reshape(chunk_shape, order=record.get("order", "C"))


def _read_array(values: dict[bytes, bytes], name: str, every_chunk: bool) -> np.ndarray:
    """Array ``name`` of the store's ``values``.  A chunk may be missing
    only where the array has a fill value and ``every_chunk`` (the
    metadata's store_array_data_equal_to_fill_value) is false: then its
    region holds the fill value; else a missing chunk raises."""
    key = f"{name}/.zarray".encode()
    if key not in values:
        raise ValueError(f"orbax checkpoint has no array {name!r}")
    record = json.loads(values[key])
    shape, chunks, zdtype = tuple(record["shape"]), tuple(record["chunks"]), record["dtype"]
    bf16 = zdtype == "bfloat16"
    dtype = np.dtype("<u2") if bf16 else np.dtype(zdtype)
    fill = record.get("fill_value")
    out = np.full(shape, fill or 0, dtype)
    leaf = Leaf((name,), shape, zdtype, chunks)
    sep = record.get("dimension_separator", ".")
    for index in leaf.grid():
        ck = f"{name}/{sep.join(map(str, index)) if index else '0'}".encode()
        if ck not in values:
            if fill is None or every_chunk:
                raise ValueError(f"orbax checkpoint array {name!r} lacks its chunk "
                                 f"{ck.decode()!r}")
            continue
        block = _decode_chunk(record, values[ck], dtype, chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def read_orbax_state(path: str) -> dict:
    """An orbax checkpoint as a nested dict of numpy arrays (0-d for
    scalars), with the tree's dicts in the order of its metadata."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT stores of zarr v2 arrays are read")
    values = ocdbt.read_store(path)
    every_chunk = bool(meta.get("store_array_data_equal_to_fill_value", False))
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        vm = entry["value_metadata"]
        if vm.get("skip_deserialize"):
            node[keys[-1]] = {}
        else:
            node[keys[-1]] = _read_array(values, ".".join(keys), every_chunk)
    return tree
