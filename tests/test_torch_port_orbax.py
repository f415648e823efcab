"""dvc_tpu's orbax checkpoints in the port, held to the libraries dvc_tpu
writes them with, on the CPU: the zstd decoder (native/dvc_zstd.cpp)
against ``zstandard``, the OCDBT store (utils/ocdbt.py) against
``tensorstore`` in both directions, and the checkpoint layer
(utils/orbax.py, train/checkpoint.py) against dvc_tpu's
``save_checkpoint(fmt="orbax")`` and ``load_last_checkpoint``, unsharded
and on dvc_tpu's 4 x 2 mesh of conftest's 8 CPU devices.  Only this test
imports zstandard and tensorstore; the port imports neither."""

import torch_threads  # noqa: F401  (one torch pool per xdist worker)
import json
import os
import shutil
import struct

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from flax import serialization

from dvc_tpu import config as JC
from dvc_tpu.parallel import mesh as jmesh
from dvc_tpu.train import checkpoint as jckpt
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu_torch.data.dataset import PairedMelDataset
from dvc_tpu_torch.native import zstd
from dvc_tpu_torch.train import checkpoint as ckpt
from dvc_tpu_torch.train.trainer import Trainer
from dvc_tpu_torch.utils import ocdbt
from dvc_tpu_torch.utils.orbax import read_orbax_state, write_orbax_state
from test_torch_port_train import _mel_tree, tiny_config

RUN = "DisentangledVAE_VCTK"
BLOCK = 128 << 10


# --- zstd ------------------------------------------------------------------------

def _payload(kind: str) -> bytes:
    rng = np.random.RandomState({"random": 1, "floats": 2, "repetitive": 3, "text": 4}[kind])
    n = 3 * BLOCK + 1234  # across the 128 KiB block boundary
    if kind == "random":
        return rng.bytes(n)
    if kind == "floats":  # weights: Huffman-coded exponents, random mantissas
        return rng.randn(n // 4).astype(np.float32).tobytes()
    if kind == "repetitive":  # long matches, repeat offsets, RLE-like runs
        parts = [bytes([rng.randint(256)]) * rng.randint(1, 300) + rng.bytes(rng.randint(1, 40))
                 for _ in range(3000)]
        return (b"".join(parts) * 2)[:n]
    words = [b"mel", b"speaker", b"content", b"style", b"frame", b"latent", b" ", b"\n"]
    return b"".join(words[i] for i in rng.randint(0, len(words), n // 4))[:n]


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", ["random", "floats", "repetitive", "text"])
def test_zstd_decodes_zstandard(kind, level, checksum):
    """Every block and literal form zstandard picks at levels 1, 3 and 19,
    with and without the content checksum, over four 128 KiB blocks."""
    data = _payload(kind)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_frame_forms():
    """A streamed frame (no content size, a window descriptor), several
    frames and a skippable frame in one buffer, empty content."""
    data = _payload("text")
    c = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = c.compress(data) + c.flush()
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    assert zstd.decompress(skippable + streamed + zstandard.compress(b"xyz")) == data + b"xyz"
    assert zstd.decompress(zstandard.compress(b"")) == b""


def test_zstd_raises_on_bad_frames():
    """Truncated frames and a flipped checksum or literal byte raise."""
    data = _payload("floats")
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for bad in (frame[:-1], frame[:-9], frame[: len(frame) // 2], frame[:6], b"\x00" * 8):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)
    flipped = bytearray(frame)
    flipped[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(flipped))
    corrupt = bytearray(frame)
    corrupt[len(frame) // 2] ^= 0xFF
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(corrupt))


@pytest.mark.parametrize("n", [0, 1, BLOCK, BLOCK + 1, 3 * BLOCK + 77])
def test_raw_frames_read_by_zstandard(n):
    data = np.random.RandomState(n).bytes(n)
    assert zstandard.ZstdDecompressor().decompress(zstd.compress_raw(data)) == data


def test_checksums():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    data = _payload("random")
    assert zstd.xxh64(data) & 0xFFFFFFFF == struct.unpack(
        "<I", zstandard.ZstdCompressor(write_checksum=True).compress(data)[-4:])[0]


# --- OCDBT -------------------------------------------------------------------------

def _ts_store(path, items, **config):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    for k, v in items.items():
        kv.write(k, v).result()
    return kv


def _items(seed, n, max_len):
    rng = np.random.RandomState(seed)
    return {f"k{rng.randint(10 ** 6):06d}/{i}".encode(): rng.bytes(rng.randint(0, max_len))
            for i in range(n)}


@pytest.mark.parametrize("n,max_len,config", [
    (1, 10, {}),
    (40, 3000, {}),                                      # inline and indirect values
    (120, 60, {"max_decoded_node_bytes": 400,            # a B-tree of several levels
               "max_inline_value_bytes": 16}),
])
def test_ocdbt_reads_tensorstore(tmp_path, n, max_len, config):
    items = _items(n, n, max_len)
    _ts_store(tmp_path / "s", items, **config)
    assert ocdbt.read_store(str(tmp_path / "s")) == items


def test_tensorstore_reads_ocdbt(tmp_path):
    """Two process stores and the root over them, as orbax lays them out;
    tensorstore reads the root and each process store."""
    a, b = _items(1, 30, 3000), _items(2, 30, 3000)
    root = str(tmp_path / "s")
    ocdbt.write_process_store(root, 0, a)
    ocdbt.write_process_store(root, 1, b)
    ocdbt.write_root(root, [0, 1])
    assert ocdbt.read_store(root) == {**a, **b}
    for path, want in ((root, {**a, **b}), (os.path.join(root, "ocdbt.process_1"), b)):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
        assert sorted(kv.list().result()) == sorted(want)
        assert all(kv.read(k).result().value == v for k, v in want.items())


def test_ocdbt_refuses_corruption(tmp_path):
    root = str(tmp_path / "s")
    ocdbt.write_process_store(root, 0, _items(3, 5, 50))
    ocdbt.write_root(root, [0])
    path = os.path.join(root, ocdbt.MANIFEST)
    blob = bytearray(open(path, "rb").read())
    blob[20] ^= 1
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ocdbt.OcdbtError, match="checksum"):
        ocdbt.read_store(root)


def test_orbax_read_raises_on_a_missing_chunk(tmp_path):
    """A store whose array lacks one chunk (fill_value null, every chunk
    stored, as both packages write) raises rather than reading zeros."""
    tree = {"a": np.arange(24, dtype=np.float32).reshape(4, 6), "b": np.float32(2.0)}
    path = write_orbax_state(str(tmp_path / "x.orbax"), tree, chunks={("a",): (2, 3)})
    got = read_orbax_state(path)
    assert np.array_equal(got["a"], tree["a"]) and got["b"] == tree["b"]
    values = ocdbt.read_store(path)
    assert {b"a/0.0", b"a/1.1"} <= set(values)
    del values[b"a/1.1"]
    cut = str(tmp_path / "cut.orbax")
    shutil.copytree(path, cut, ignore=lambda d, names: [
        n for n in names if d == path and (n.startswith("ocdbt.") or n in (ocdbt.MANIFEST, "d"))])
    ocdbt.write_process_store(cut, 0, values)
    ocdbt.write_root(cut, [0])
    with pytest.raises(ValueError, match="lacks its chunk 'a/1.1'"):
        read_orbax_state(cut)


# --- orbax checkpoints of the TrainState, both ways -------------------------------------

def _jax_trainer(ck, use_mesh):
    vae = JC.VAEConfig(frames=16, dim_neck=8, enc_channels=32, dim_pre=32,
                       dec_lstm2_hidden=32, postnet_channels=32)
    cfg = JC.Config(vae=vae, train=JC.TrainConfig(batch_size=4, compute_dtype="float32",
                                                  checkpoint_format="orbax", seed=5),
                    mesh=JC.MeshConfig(model_parallel=2))
    return JaxTrainer(cfg, checkpoints_path=str(ck), use_mesh=use_mesh)


def _trained(ck, use_mesh):
    """dvc_tpu's tiny Trainer after one step (Adam's moments non-zero)."""
    tr = _jax_trainer(ck, use_mesh)
    rng = np.random.RandomState(0)
    x1, x2 = (rng.rand(4, 80, 16).astype(np.float32) for _ in range(2))
    if use_mesh:
        x1, x2 = jmesh.shard_batch((x1, x2), tr.mesh)
    tr.state, _ = tr.train_step(tr.state, x1, x2, tr._rng)
    return tr


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_bit_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module", params=[False, True], ids=["unsharded", "mesh4x2"])
def jax_saved(request, tmp_path_factory):
    ck = tmp_path_factory.mktemp("orbax")
    tr = _trained(ck, request.param)
    path = tr.save(epoch=7)
    return tr, path, serialization.to_state_dict(jax.device_get(tr.state))


def test_read_orbax_state_equals_dvc_tpu(jax_saved):
    """The port reads dvc_tpu's store, unsharded or written in the 4 x 2
    mesh's shards, leaf for leaf as the state, and as the .msgpack tree."""
    tr, path, want = jax_saved
    if tr._state_shardings is not None:  # model- and ZeRO-sharded leaves, 4 x 2
        specs = {str(x.sharding.spec) for x in jax.tree_util.tree_leaves(tr.state)}
        assert any("model" in s for s in specs) and any("data" in s for s in specs)
    got = read_orbax_state(path)
    _assert_bit_equal(got, want)
    assert got["opt_state"]["1"] == {}
    assert list(got) == ["step", "params", "batch_stats", "opt_state"]
    mp = os.path.join(os.path.dirname(path), "state.msgpack")
    with open(mp, "wb") as f:
        f.write(serialization.to_bytes(tr.state))
    _assert_bit_equal(got, ckpt.read_train_state(mp))


def test_zstd_decodes_every_frame_of_a_store(jax_saved):
    """Every zstd frame tensorstore wrote into dvc_tpu's store (the B-tree
    nodes' and manifests' bodies, every chunk) decodes as zstandard
    decodes it."""
    _, path, _ = jax_saved
    n = 0
    for d, _, files in os.walk(path):
        for f in files:
            blob = open(os.path.join(d, f), "rb").read()
            i = blob.find(zstd.MAGIC)
            while i >= 0:
                obj = zstandard.ZstdDecompressor().decompressobj()
                try:
                    want = obj.decompress(blob[i:])
                except zstandard.ZstdError:  # the magic's bytes inside other data
                    i = blob.find(zstd.MAGIC, i + 1)
                    continue
                end = len(blob) - len(obj.unused_data)
                assert zstd.decompress(blob[i:end]) == want
                n += 1
                i = blob.find(zstd.MAGIC, end)
    assert n > 100


def test_dvc_tpu_restores_port_store(jax_saved, tmp_path):
    """The port writes the same state (in dvc_tpu's shards' chunk grid for
    the mesh case); dvc_tpu's load_last_checkpoint restores it bit-equal,
    with the trainer's mesh shardings and without."""
    tr, path, want = jax_saved
    tree = read_orbax_state(path)
    chunks = None
    if tr._state_shardings is not None:
        chunks = {tuple(str(getattr(q, "key", getattr(q, "idx", q))) for q in k):
                  tuple(x.sharding.shard_shape(x.shape)) for k, x in
                  jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(tr.state))}
    out = tmp_path / f"{RUN}_9.orbax"
    write_orbax_state(str(out), tree, chunks)
    meta = json.load(open(out / "_METADATA"))
    assert meta["use_ocdbt"] and not meta["use_zarr3"]
    for sh in [None] + [tr._state_shardings] * (tr._state_shardings is not None):
        epoch, state = jckpt.load_last_checkpoint(str(tmp_path), tr.state, shardings=sh)
        assert epoch == 9
        _assert_bit_equal(serialization.to_state_dict(jax.device_get(state)), want)
        if sh is not None:  # the restored arrays carry the trainer's shardings
            assert any("data" in str(x.sharding.spec)
                       for x in jax.tree_util.tree_leaves(state.opt_state)
                       if hasattr(x, "sharding"))


def test_port_save_is_read_by_dvc_tpu(tmp_path):
    """train_state_tree through save_checkpoint(fmt="orbax"): the .orbax
    beside the .opt.pth and .pth pair; dvc_tpu's Trainer resumes the .orbax
    to the .msgpack's state."""
    torch.manual_seed(0)
    one = Trainer(tiny_config(), checkpoints_path=str(tmp_path / "o"), device="cpu")
    one.step_on(torch.rand(2, 80, 16), torch.rand(2, 80, 16))
    one.step = 1
    for fmt, d in (("orbax", "o"), ("msgpack", "m")):
        one.cfg = one.cfg.replace(train=tiny_config(checkpoint_format=fmt).train)
        one.checkpoints_path = str(tmp_path / d)
        one.save(4)
    assert sorted(os.listdir(tmp_path / "o")) == [f"{RUN}_4{s}" for s in
                                                ((".opt.pth", ".orbax", ".pth"))]
    _assert_bit_equal(read_orbax_state(str(tmp_path / "o" / f"{RUN}_4.orbax")),
                      ckpt.read_train_state(str(tmp_path / "m" / f"{RUN}_4.msgpack")))
    os.remove(tmp_path / "o" / f"{RUN}_4.pth")  # the .orbax is now the newest
    jtr = JaxTrainer(JC.Config(vae=JC.VAEConfig(frames=16, dim_neck=8, enc_channels=32,
                                                dim_pre=32, dec_lstm2_hidden=32,
                                                postnet_channels=32),
                               train=JC.TrainConfig(batch_size=2, compute_dtype="float32")),
                     checkpoints_path=str(tmp_path / "o"), use_mesh=False)
    assert jtr.load_last() == 5
    want = ckpt.read_train_state(str(tmp_path / "m" / f"{RUN}_4.msgpack"))
    _assert_bit_equal(serialization.to_state_dict(jax.device_get(jtr.state)), want)


def test_orbax_resume_equals_straight_training(tmp_path):
    """--checkpoint-format orbax: 2 epochs, resume from the .orbax alone (the
    .pth pair removed), 1 epoch, ends where 3 straight epochs and a msgpack
    resume end."""
    _mel_tree(str(tmp_path / "mels"))

    def dataset():
        return PairedMelDataset(str(tmp_path / "mels"), samples_length=16, seed=0)

    quiet = dict(report_interval=1, logging_func=lambda *a: None)
    straight = Trainer(tiny_config(), device="cpu")
    straight.run_training(dataset(), 3, **quiet)
    ends = []
    for fmt in ("orbax", "msgpack"):
        ck = str(tmp_path / fmt)
        ds = dataset()
        first = Trainer(tiny_config(checkpoint_format=fmt), checkpoints_path=ck, device="cpu")
        first.run_training(ds, 2, **quiet)
        if fmt == "orbax":
            for e in (1, 2):
                os.remove(os.path.join(ck, f"{RUN}_{e}.pth"))
                os.remove(os.path.join(ck, f"{RUN}_{e}.opt.pth"))
            assert sorted(os.listdir(ck)) == [f"{RUN}_1.orbax", f"{RUN}_2.orbax"]
        resumed = Trainer(tiny_config(checkpoint_format=fmt), checkpoints_path=ck,
                          device="cpu")
        assert resumed.load_last() == 3 and resumed.step == first.step > 0
        sa, sb = first.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
        for k in sa:
            for f in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[k][f], sb[k][f])
        resumed.run_training(ds, 1, **quiet)
        ends.append(resumed.model.state_dict())
    for n, a in straight.model.state_dict().items():
        if n.endswith("num_batches_tracked"):  # dvc_tpu's tree has no place for it
            continue
        torch.testing.assert_close(ends[0][n], a, rtol=1e-6, atol=1e-7, msg=n)
        assert torch.equal(ends[0][n], ends[1][n]), n
