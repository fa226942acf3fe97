"""The JAX package's Orbax checkpoints read and written by the port without
orbax: the zstd decoder against ``zstandard``, the OCDBT store against
tensorstore, ``read_pytree`` against orbax's bare restore (every leaf kind,
the JAX ``Trainer``'s checkpoints of four configurations, a protocol
carry, the committed fixture), and every entry point that takes such a
checkpoint against its JAX counterpart: the predictor, the trainer's
resume (the optax chain's state as torch Adam's), the protocols, the
``.pth`` and ``.pt2`` exports and ``evaluate``; the port's
``save_orbax_checkpoint`` read back by orbax and by the JAX package."""

import contextlib
import json
import os
import struct
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from flax import linen as fnn

from pointcloud_orientation_tpu import models as jax_models
from pointcloud_orientation_tpu.data import OrientationDataset as JaxDataset
from pointcloud_orientation_tpu.infer import OrientationPredictor as JaxPredictor
from pointcloud_orientation_tpu.losses import soft_label_kl_8dir as jax_kl
from pointcloud_orientation_tpu.models.layers import PointNetPPTrunk as JaxTrunk
from pointcloud_orientation_tpu.train import Trainer as JaxTrainer
from pointcloud_orientation_tpu.train import protocol_ckpt as jax_pc
from pointcloud_orientation_tpu.train.config import TrainConfig as JaxConfig
from pointcloud_orientation_tpu.train.trainer import TrainState
from pointcloud_orientation_tpu.utils import torch_export as jax_torch_export
from pointcloud_orientation_tpu_torch import OrientationPredictor
from pointcloud_orientation_tpu_torch.data import OrientationDataset
from pointcloud_orientation_tpu_torch.ops import cuda_kernels as K
from pointcloud_orientation_tpu_torch.train import Trainer, TrainConfig, preset
from pointcloud_orientation_tpu_torch.train import protocol_ckpt as PC
from pointcloud_orientation_tpu_torch.train.evaluate import evaluate
from pointcloud_orientation_tpu_torch.utils import ocdbt, orbax_format, random_flax_variables
from pointcloud_orientation_tpu_torch.utils import to_flax_variables, zstd
from pointcloud_orientation_tpu_torch.utils import torch_export as port_torch_export
from pointcloud_orientation_tpu_torch.utils.aot_export import read_checkpoint
from pointcloud_orientation_tpu_torch.utils.orbax_format import read_pytree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_make_orbax_fixture as fixture  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "orbax_transformer")
B, N, LR = 4, 256, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (see tests/test_torch_per_label.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_tree(got, want, path="") -> None:
    """``got`` (``read_pytree``'s) equals ``want`` (orbax's restore) in
    nesting, types, dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), (path, type(got))
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (path, type(got))
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def orbax_restore(path):
    with ocp.PyTreeCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(path))


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(0)
    with open(os.path.join(REPO, "README.md"), "rb") as f:
        text = f.read()[:40_000]
    return {"empty": b"", "floats": rng.normal(size=20_000).astype(np.float32).tobytes(),
            "zeros": bytes(100_000), "text": text,
            "several_blocks": text * 3 + rng.integers(0, 4, 150_000).astype(np.uint8).tobytes()}


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19, -5])
def test_zstd_decodes_zstandard_frames(level, checksum):
    """Every payload (the last over 128 KiB, so several blocks) through
    ``zstandard`` at the level, with and without the XXH64 checksum."""
    comp = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    for name, data in _payloads().items():
        assert zstd.decompress(comp.compress(data)) == data, name


def test_zstd_frames_in_a_row_and_streamed():
    p = _payloads()
    frames = b"".join(zstandard.ZstdCompressor(level=lv).compress(p[k])
                      for lv, k in ((1, "text"), (3, "empty"), (19, "floats")))
    assert zstd.decompress(frames) == p["text"] + p["floats"]
    co = zstandard.ZstdCompressor(level=3, write_content_size=False).compressobj()
    streamed = co.compress(p["several_blocks"]) + co.flush()
    assert zstd.decompress(streamed) == p["several_blocks"]
    for n in (0, 5, 31, 32, 1000):
        data = os.urandom(n)
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")


def test_zstd_refusals():
    data = _payloads()["text"]
    dictionary = zstandard.train_dictionary(4096, [data[i: i + 800] for i in range(0, 32_000, 400)])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(zstandard.ZstdCompressor(dict_data=dictionary).compress(data[:2000]))
    frame = bytearray(zstandard.ZstdCompressor(write_checksum=True).compress(data))
    frame[-1] ^= 1
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame[: len(frame) // 2]))
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"\0" * 16)
    assert issubclass(zstd.ZstdError, ValueError)


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

_STORES = {
    "small-nodes": ({"max_decoded_node_bytes": 400, "max_inline_value_bytes": 50,
                     "version_tree_arity_log2": 2}, 7),
    "many-versions": ({"version_tree_arity_log2": 1}, 13),
    "uncompressed": ({"compression": None, "max_inline_value_bytes": 16}, 3),
    "zstd-level-3": ({"compression": {"id": "zstd", "level": 3}}, 2),
}


def _kvstore(path, config=None):
    spec = {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/"}
    if config is not None:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _assert_store_matches(path):
    kv = _kvstore(path)
    want = sorted(k.decode() for k in kv.list().result())
    store = ocdbt.Store(str(path))
    assert store.keys() == want == ocdbt.list_keys(str(path))
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    return want


@pytest.mark.parametrize("name", list(_STORES))
def test_ocdbt_lists_and_reads_as_tensorstore(tmp_path, name):
    """Interior nodes (small nodes), version-tree nodes (many commits at
    arity 2), values inline and indirect, nodes compressed or not."""
    config, commits = _STORES[name]
    kv = _kvstore(tmp_path, config)
    rng = np.random.default_rng(1)
    for t in range(commits):
        with ts.Transaction() as txn:
            for j in range(30):
                kv.with_transaction(txn)[f"grp{t % 3}/item_{j:03d}/v.{t}"] = rng.bytes(
                    int(rng.integers(0, 120)))
    assert len(_assert_store_matches(tmp_path)) == 30 * commits
    assert ocdbt.read(str(tmp_path), "grp0/item_000/v.0") == kv.read(
        "grp0/item_000/v.0").result().value


def test_ocdbt_writer_is_read_by_tensorstore(tmp_path):
    items = {f"a/{i}": os.urandom(i * 37 % 3000) for i in range(50)}
    items["a/"] = b""
    ocdbt.write_store(str(tmp_path), items)
    kv = _kvstore(tmp_path)
    assert sorted(k.decode() for k in kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v == ocdbt.read(str(tmp_path), k)


def test_ocdbt_refuses_other_formats(tmp_path):
    ocdbt.write_store(str(tmp_path), {"k": b"v"})
    path = tmp_path / "manifest.ocdbt"
    good = path.read_bytes()

    def patched(offset, value):
        data = bytearray(good)
        data[offset] = value
        data[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(data[:-4])))
        path.write_bytes(bytes(data))

    patched(14 + 16, 1)  # manifest kind: numbered manifests
    with pytest.raises(ValueError, match="numbered"):
        ocdbt.Store(str(tmp_path))
    patched(13, 2)  # an unknown compression format
    with pytest.raises(ValueError, match="compression format 2"):
        ocdbt.Store(str(tmp_path))
    path.write_bytes(good[:-1] + bytes([good[-1] ^ 1]))
    with pytest.raises(ValueError, match="CRC"):
        ocdbt.Store(str(tmp_path))
    with pytest.raises(ValueError, match="manifest.ocdbt"):
        ocdbt.Store(str(tmp_path / "nowhere"))


# ---------------------------------------------------------------------------
# zarr leaves and the tree
# ---------------------------------------------------------------------------

def _leaf_kinds():
    rng = np.random.default_rng(2)
    tree = {
        "f4": rng.normal(size=(3, 5)).astype(np.float32),
        "f8": rng.normal(size=(7,)),
        "i4": np.arange(-6, 6, dtype=np.int32).reshape(2, 6),
        "i8": np.arange(5, dtype=np.int64) * (1 << 40),
        "b1": rng.random(9) > 0.5,
        "u1": rng.integers(0, 256, (4, 4)).astype(np.uint8),
        "bf16": rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16),
        "scalar0d": np.asarray(3, np.int32),
        "chunked": rng.normal(size=(10, 101)).astype(np.float32),
        "py": {"int": 7, "float": 2.5, "bool": True, "npint": np.int32(3)},
        "nested": [[np.ones(2), {"x": np.zeros(3, np.uint8)}], (np.float32(1.5),)],
        "none": None, "empty_dict": {}, "empty_list": [],
    }
    save_args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(), tree)
    save_args["chunked"] = ocp.SaveArgs(chunk_byte_size=1024)  # several chunks, edge ones
    return tree, save_args


def test_read_pytree_matches_orbax_on_every_leaf_kind(tmp_path):
    tree, save_args = _leaf_kinds()
    path = str(tmp_path / "kinds")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, args=ocp.args.PyTreeSave(tree, save_args=save_args))
    assert sum(k.startswith("chunked/") for k in ocdbt.list_keys(path)) > 2
    assert_same_tree(read_pytree(path), orbax_restore(path))


@pytest.mark.parametrize("compressor", [{"id": "zstd", "level": 3}, None], ids=["zstd", "raw"])
def test_read_array_matches_tensorstore_zarr(tmp_path, compressor):
    """A zarr v2 array that tensorstore wrote into an OCDBT store with
    edge chunks, two chunks of nine written and the rest missing (read as
    ``fill_value``), zstd-compressed or raw."""
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "a.b", "create": True,
            "metadata": {"dtype": "<f4", "shape": [10, 7], "chunks": [4, 3], "fill_value": 1.5,
                         "compressor": compressor, "order": "C",
                         "dimension_separator": "."}}
    arr = ts.open(spec).result()
    arr[0:4, 0:3] = np.arange(12, dtype=np.float32).reshape(4, 3)
    arr[8:10, 6:7] = np.asarray([[7.0], [8.0]], np.float32)
    store = ocdbt.Store(str(tmp_path))
    assert len(store.keys()) == 3
    got, want = orbax_format.read_array(store, "a.b"), arr.read().result()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_read_array_refuses_what_it_does_not_read(tmp_path):
    for meta, message in (({"compressor": {"id": "zlib"}}, "zlib"), ({"order": "F"}, "order"),
                          ({"dimension_separator": "/"}, "dimension_separator"),
                          ({"dtype": ">f4"}, ">f4"), ({"filters": [{"id": "delta"}]}, "filters"),
                          ({"zarr_format": 3}, "zarr_format")):
        zarray = {"chunks": [2], "compressor": None, "dimension_separator": ".",
                  "dtype": "<f4", "fill_value": None, "filters": None, "order": "C",
                  "shape": [2], "zarr_format": 2, **meta}
        ocdbt.write_store(str(tmp_path), {"x/.zarray": json.dumps(zarray).encode(),
                                          "x/0": bytes(8)})
        with pytest.raises(ValueError, match=message):
            orbax_format.read_array(ocdbt.Store(str(tmp_path)), "x")


def test_bfloat16_widens_exactly_without_ml_dtypes(tmp_path, monkeypatch):
    tree, save_args = _leaf_kinds()
    path = str(tmp_path / "kinds")
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(path, args=ocp.args.PyTreeSave(tree, save_args=save_args))
    monkeypatch.setattr(orbax_format, "_bfloat16", lambda: None)
    got = read_pytree(path)["bf16"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(tree["bf16"], np.float32))


@pytest.mark.parametrize("option,message", [({"use_zarr3": True}, "zarr3"),
                                            ({"use_ocdbt": False}, "OCDBT")])
def test_read_pytree_refuses_zarr3_and_stores_outside_ocdbt(tmp_path, option, message):
    path = str(tmp_path / "c")
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(**option)) as ckptr:
        ckptr.save(path, args=ocp.args.PyTreeSave({"a": np.ones(3, np.float32)}))
    with pytest.raises(ValueError, match=message):
        read_pytree(path)


def test_write_pytree_is_restored_by_orbax(tmp_path):
    tree, _ = _leaf_kinds()
    tree["nested"][1] = [np.float32(1.5)]
    path = orbax_format.write_pytree(str(tmp_path / "step_1"), tree)
    want = orbax_restore(path)
    assert_same_tree(read_pytree(path), want)
    assert want["none"] is None and want["py"]["int"] == 7
    np.testing.assert_array_equal(want["chunked"], tree["chunked"])
    assert want["bf16"].dtype == ml_dtypes.bfloat16


# ---------------------------------------------------------------------------
# the JAX Trainer's checkpoints
# ---------------------------------------------------------------------------

class _NoDropPP8Dir(fnn.Module):
    """PointNetPP8Dir's variable tree with dropout off and the first points
    as centroids: the function both frameworks run."""

    @fnn.compact
    def __call__(self, xyz, train: bool = False):
        return fnn.Dense(8)(JaxTrunk(p_drop=0.0, sampling="first")(xyz, train=train))


def _batch(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(B, N, 3))
    probs = rng.dirichlet(np.ones(8), size=B)
    valid = np.asarray([1.0] * (B - 1) + [0.0])
    return pts, probs, valid


def _jax_step_fn(tx):
    """One train step of the deterministic model through the trainer's
    optax chain ``tx``, jitted; run under x64 in float64."""
    model = _NoDropPP8Dir()

    def loss_fn(params, stats, pts, probs, valid):
        logits, mut = model.apply({"params": params, "batch_stats": stats}, pts, train=True,
                                  mutable=["batch_stats"])
        _, per = jax_kl(logits, probs)
        return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0), mut["batch_stats"]

    @jax.jit
    def step(params, stats, opt_state, pts, probs, valid):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, pts, probs, valid)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, new_stats, optax.apply_updates(params, updates), opt_state

    return step


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), tree)


def _f32(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a), tree)


def _jax_8dir_dataset(cls):
    return cls.synthetic(samples_per_class=4, num_points=N, class_names=["chair"])


class _JaxStandIn:
    """What the JAX ``Trainer.save_checkpoint`` and ``restore_checkpoint``
    read of a ``Trainer``: a flax ``TrainState`` (``step``, ``params``,
    ``batch_stats``, ``opt_state`` of ``tx``), no mesh, no asynchronous
    writer. A full-width JAX ``Trainer`` takes long to build on the CPU
    (its model's init); its two checkpoint methods run here as they are,
    on ``tx`` = the chain that it builds for the config (``optax.chain`` of
    ``optax.adam(lr)`` for 8dir_kl and the classifier's defaults)."""

    save_checkpoint = JaxTrainer.save_checkpoint
    restore_checkpoint = JaxTrainer.restore_checkpoint

    def __init__(self, variables, tx):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        self.tx, self.mesh, self._async_ckptr = tx, None, None
        self.state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                   variables["batch_stats"]),
                                opt_state=tx.init(params))


def _jax_8dir_checkpoint(directory):
    """The JAX 8dir_kl ``Trainer``'s checkpoint at full width (B=4, N=256)
    after one step of its Adam chain in float64 on the deterministic
    model, written by its ``save_checkpoint`` into ``directory``
    (``step_1``); the stand-in, the jitted step for the resumed one, the
    path."""
    jt = _JaxStandIn(random_flax_variables(11), optax.chain(optax.adam(LR)))
    step = _jax_step_fn(jt.tx)
    with jax.enable_x64(True):
        _, stats, params, opt = tree_np(step(*_f64((jt.state.params, jt.state.batch_stats,
                                                    jt.state.opt_state)), *_batch(1)))
    jt.state = jt.state.replace(params=_f32(params), batch_stats=_f32(stats),
                                opt_state=_f32(opt), step=jnp.asarray(1, jnp.int32))
    return jt, step, jt.save_checkpoint(directory)


@pytest.fixture(scope="module")
def jax_8dir(tmp_path_factory):
    return _jax_8dir_checkpoint(str(tmp_path_factory.mktemp("jax8")))


_SERVE = dict(num_points=N, max_batch=B, sampling="first")
_JAX_PREDICTORS = {}


def _jax_predictor(path):
    """The JAX ``from_orbax_checkpoint`` predictor of ``path`` (kept: each
    compiles its request)."""
    if path not in _JAX_PREDICTORS:
        _JAX_PREDICTORS[path] = JaxPredictor.from_orbax_checkpoint(path, "pointnet_pp_8dir",
                                                                   **_SERVE)
    return _JAX_PREDICTORS[path]


def _port_8dir(**kw):
    return Trainer(preset("8dir_kl", batch_size=B, num_points=N, epochs=1, **kw),
                   _jax_8dir_dataset(OrientationDataset), device="cpu", sampling="first",
                   p_drop=0.0)


def _jax_trainer_checkpoint(jt, directory):
    """A JAX ``Trainer``'s checkpoint after one update of its chain with
    seeded gradients (its moments and counts nonzero)."""
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32),
                                   tree_np(jt.state.params))
    @jax.jit
    def update(params, opt_state):
        updates, opt_state = jt.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt = update(jt.state.params, jt.state.opt_state)
    jt.state = jt.state.replace(params=params, opt_state=opt, step=jnp.asarray(1, jnp.int32))
    return jt, jt.save_checkpoint(directory)


_SMALL_DS = dict(samples_per_class=4, num_points=64, class_names=["chair"])
# the MoE transformer's widths, narrowed on both sides (its tree fixes them)
_MOE_WIDTHS = dict(embed_dim=16, num_heads=2, depth=2, ffn_dim=32)


class _NarrowMoE(jax_models.MODEL_REGISTRY["moe_point_transformer"]):
    embed_dim: int = _MOE_WIDTHS["embed_dim"]
    num_heads: int = _MOE_WIDTHS["num_heads"]
    depth: int = _MOE_WIDTHS["depth"]
    ffn_dim: int = _MOE_WIDTHS["ffn_dim"]

_CONFIGS = {  # name -> the config of both packages, B=4 and N=64
    "sgd-cosine-clip": dict(model="simple_pointnet", task="forward_mse", optimizer="sgd",
                            lr_schedule="cosine", warmup_epochs=1, epochs=3, grad_clip=1.0),
    "classifier": dict(model="pointnet_pp_cls", task="classification"),
    "moe-transformer": dict(model="moe_point_transformer", task="forward_mse_aux",
                            rotation_mode="so3"),
}


@pytest.fixture(scope="module")
def jax_small(tmp_path_factory):
    """The JAX checkpoints of ``_CONFIGS`` (name -> (JAX trainer, path)):
    JAX ``Trainer``s for the SGD configuration and the MoE transformer (at
    ``_MOE_WIDTHS``), the full-width classifier on a stand-in
    (``_JaxStandIn``)."""
    out = {}
    wide = jax_models.MODEL_REGISTRY["moe_point_transformer"]
    jax_models.MODEL_REGISTRY["moe_point_transformer"] = _NarrowMoE
    try:
        for name, kw in _CONFIGS.items():
            if name == "classifier":
                jt = _JaxStandIn(random_flax_variables(12, "pointnet_pp_cls"),
                                 optax.chain(optax.adam(LR)))
            else:
                jt = JaxTrainer(JaxConfig(batch_size=B, num_points=64, **kw),
                                JaxDataset.synthetic(**_SMALL_DS))
            out[name] = _jax_trainer_checkpoint(jt, str(tmp_path_factory.mktemp(name)))
    finally:
        jax_models.MODEL_REGISTRY["moe_point_transformer"] = wide
    return out


def _port_small(name):
    kw = _MOE_WIDTHS if name == "moe-transformer" else {}
    return Trainer(TrainConfig(batch_size=B, num_points=64, **_CONFIGS[name]),
                   OrientationDataset.synthetic(**_SMALL_DS), device="cpu", **kw)


def test_read_pytree_matches_orbax_on_a_full_width_checkpoint(jax_8dir):
    """The 8dir_kl checkpoint after a step: 163 leaves (the chain's
    EmptyState a None), read bit for bit, through the root manifest over
    ``ocdbt.process_0`` (both layouts read as tensorstore reads them)."""
    _, _, path = jax_8dir
    got = read_pytree(path)
    assert_same_tree(got, orbax_restore(path))
    assert got["opt_state"][0][1] is None and int(got["step"]) == 1
    assert int(got["opt_state"][0][0]["count"]) == 1
    assert _assert_store_matches(path) == _assert_store_matches(
        os.path.join(path, "ocdbt.process_0"))


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_read_pytree_matches_orbax_on_other_configurations(jax_small, name):
    """Then the port's Trainer of the configuration loads the tree."""
    _, path = jax_small[name]
    tree = read_pytree(path)
    assert_same_tree(tree, orbax_restore(path))
    trainer = _port_small(name)
    assert trainer.load_flax_state(tree) == 1 // max(1, -(-len(trainer.train_ds) // B))
    assert_same_tree(to_flax_variables(trainer.model)["params"], tree["params"])


def test_from_orbax_checkpoint_matches_the_jax_predictor(jax_8dir):
    """sampling="first", bucket 4 and 8 clouds: the bound of
    tests/test_torch_infer.py (1e-4 on the logits, 1e-5 on the vectors)."""
    _, _, path = jax_8dir
    clouds = np.random.default_rng(4).normal(size=(3, 200, 3)).astype(np.float32)
    want = _jax_predictor(path)
    got = OrientationPredictor.from_orbax_checkpoint(path, "pointnet_pp_8dir", device="cpu",
                                                     **_SERVE)
    np.testing.assert_allclose(got(clouds), np.asarray(want(clouds)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.forward_vectors(clouds), want.forward_vectors(clouds),
                               rtol=1e-5, atol=1e-5)


def _pre_bn_bias(path) -> bool:
    keys = [p.key for p in path]
    return keys[-1] == "bias" and keys[-2].startswith("Dense") and len(keys) > 2


def test_restored_trainer_steps_as_the_jax_resumed_step(jax_8dir):
    """The port's Trainer restored from the JAX checkpoint (Adam's count 1,
    its moments nonzero) takes a step on a new batch; the JAX package's
    ``restore_checkpoint`` and the same step through its chain. Both in
    float64 under tests/test_torch_train_step.py's 'auto-f64' rules: loss
    1e-5 relative, statistics 1e-6, parameters 1e-5 after the step, and the
    Dense biases before a train BatchNorm (gradient zero but for rounding)
    held to |change| <= lr * 1.0014, Adam's largest second step
    (|m_hat| / sqrt(v_hat) <= 1.0014 over two steps)."""
    jt, step, path = jax_8dir
    jt.restore_checkpoint(path)
    pts, probs, valid = _batch(2)
    with jax.enable_x64(True):
        params0 = _f64(jt.state.params)
        loss, stats, params, _ = tree_np(step(params0, *_f64((jt.state.batch_stats,
                                                               jt.state.opt_state)),
                                              pts, probs, valid))
    trainer = _port_8dir()
    trainer.model.to(torch.float64)
    assert trainer.restore_checkpoint(path) == 1 and trainer.step == 1
    batch = {"points": torch.from_numpy(pts), "probs_8dir": torch.from_numpy(probs),
             "forward": torch.zeros(B, 3, dtype=torch.float64)}
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(K, "sa_group", K.sa_group_plain))
        stack.enter_context(mock.patch.object(K, "sa_group_scatter", K.sa_group_scatter_plain))
        hook = trainer.model.trunk.register_forward_hook(  # the JAX trunk returns float32
            lambda module, args, out: out.float().double())
        stack.callback(hook.remove)
        got_loss = float(trainer.train_step(batch, torch.from_numpy(valid), None)["loss"])
    got = to_flax_variables(trainer.model)
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got["batch_stats"]),
                              jax.tree_util.tree_leaves_with_path(stats)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=jax.tree_util.keystr(p))
    checked = 0
    for (p, a), (_, b), (_, a0) in zip(jax.tree_util.tree_leaves_with_path(got["params"]),
                                       jax.tree_util.tree_leaves_with_path(params),
                                       jax.tree_util.tree_leaves_with_path(params0)):
        if _pre_bn_bias(p):
            assert np.abs(a - a0).max() <= LR * 1.0014 and np.abs(b - a0).max() <= LR * 1.0014
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=jax.tree_util.keystr(p))
        checked += 1
    assert checked == 3 * 9 + 2 * 3 + 2


def _same_gradients_step(jt, path, trainer, seed=5):
    """The chain restored on both sides, one update from the same seeded
    gradients; returns (port's params, JAX params) as flax trees."""
    jt.restore_checkpoint(path)
    rng = np.random.default_rng(seed)
    grads = jax.tree_util.tree_map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32),
                                   tree_np(jt.state.params))
    update = jax.jit(lambda p, o: optax.apply_updates(p, jt.tx.update(grads, o, p)[0]))
    want = tree_np(update(jt.state.params, jt.state.opt_state))
    from pointcloud_orientation_tpu_torch.utils.jax_weights import flax_parameter_paths
    from pointcloud_orientation_tpu_torch.utils.jax_weights import from_flax_layout
    for name, (fpath, _, kind) in flax_parameter_paths(trainer.model).items():
        p = trainer.model.get_parameter(name)
        g = grads
        for k in fpath:
            g = g[k]
        p.grad = from_flax_layout(torch.from_numpy(np.array(g)), tuple(p.shape), kind).contiguous()
    trainer.optimizer_step()
    return to_flax_variables(trainer.model)["params"], want


@pytest.mark.parametrize("name", ["8dir-adam", "sgd-cosine-clip"])
def test_restored_chain_updates_as_optax_on_the_same_gradients(jax_8dir, jax_small, name):
    """Adam's count, moments and rate, and the clip and the cosine schedule's
    position under SGD, carried: one update from the same gradients equals
    optax's within 1e-6 (tests/test_torch_train_step.py's bound)."""
    if name == "8dir-adam":
        jt, _, path = jax_8dir
        trainer = _port_8dir()
    else:
        jt, path = jax_small[name]
        trainer = _port_small(name)
    assert trainer.restore_checkpoint(path) == 1 // max(1, -(-len(trainer.train_ds) // B))
    got, want = _same_gradients_step(jt, path, trainer)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("name", ["8dir-adam"] + list(_CONFIGS))
def test_save_orbax_checkpoint_round_trips_through_the_jax_package(jax_8dir, jax_small, name,
                                                                  tmp_path):
    """JAX checkpoint -> the port's Trainer -> ``save_orbax_checkpoint``:
    orbax's bare restore gives the JAX checkpoint's tree bit for bit, the
    JAX ``Trainer.restore_checkpoint`` (a templated restore) reads it into
    the same state, and the JAX predictor serves it (8-dir) as it serves the
    JAX checkpoint."""
    if name == "8dir-adam":
        jt, _, path = jax_8dir
        trainer = _port_8dir()
    else:
        jt, path = jax_small[name]
        trainer = _port_small(name)
    trainer.restore_checkpoint(path)
    out = trainer.save_orbax_checkpoint(str(tmp_path))
    assert out == str(tmp_path / "step_1")
    original = orbax_restore(path)
    assert_same_tree(orbax_restore(out), original)
    jt.restore_checkpoint(out)
    state = tree_np({"params": jt.state.params, "batch_stats": jt.state.batch_stats,
                     "opt_state": jt.state.opt_state, "step": jt.state.step})
    jt.restore_checkpoint(path)
    want = tree_np({"params": jt.state.params, "batch_stats": jt.state.batch_stats,
                    "opt_state": jt.state.opt_state, "step": jt.state.step})
    assert jax.tree_util.tree_structure(state) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if name == "8dir-adam":
        clouds = np.random.default_rng(6).normal(size=(2, N, 3)).astype(np.float32)
        got = JaxPredictor.from_orbax_checkpoint(out, "pointnet_pp_8dir", **_SERVE)
        got._apply = _jax_predictor(path)._apply  # the same compiled request
        np.testing.assert_array_equal(got(clouds), _jax_predictor(path)(clouds))


def test_async_save_orbax_checkpoint_writes_the_same_tree(jax_small, tmp_path):
    _, path = jax_small["sgd-cosine-clip"]
    trainer = _port_small("sgd-cosine-clip")
    trainer.restore_checkpoint(path)
    a = trainer.save_orbax_checkpoint(str(tmp_path / "sync"))
    b = trainer.save_orbax_checkpoint(str(tmp_path / "async"), step=7, asynchronous=True)
    trainer.wait_for_checkpoints()
    assert b.endswith("step_7")
    assert_same_tree(read_pytree(b), read_pytree(a))


def test_trainer_refuses_a_checkpoint_of_another_chain(jax_small):
    _, path = jax_small["sgd-cosine-clip"]
    cfg = TrainConfig(batch_size=B, num_points=64, **{**_CONFIGS["sgd-cosine-clip"],
                                                      "grad_clip": None})
    trainer = Trainer(cfg, OrientationDataset.synthetic(**_SMALL_DS), device="cpu")
    with pytest.raises(ValueError, match="optax chain"):
        trainer.restore_checkpoint(path)
    with pytest.raises(ValueError, match="learning-rate"):
        Trainer(cfg.replace(grad_clip=1.0, lr_schedule=None),
                OrientationDataset.synthetic(**_SMALL_DS), device="cpu").restore_checkpoint(path)


def test_torch_export_cli_matches_the_jax_cli(jax_small, tmp_path, capsys):
    _, path = jax_small["sgd-cosine-clip"]
    args = ["--orbax", path, "--model", "simple_pointnet", "--out"]
    jax_torch_export._main(args + [str(tmp_path / "jax.pth")])
    port_torch_export.main(args + [str(tmp_path / "port.pth")])
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert "wrote" in capsys.readouterr().out


def test_evaluate_and_read_checkpoint_read_the_jax_weights(jax_small, tmp_path):
    """``read_checkpoint(DIR)`` gives orbax's params and statistics bit for
    bit; ``evaluate(ckpt=DIR)`` gives the same numbers as evaluating the
    ``.pth`` that the JAX CLI writes from the same directory."""
    _, path = jax_small["sgd-cosine-clip"]
    params, stats = read_checkpoint(path, "simple_pointnet")
    want = orbax_restore(path)
    assert_same_tree(params, want["params"])
    assert_same_tree(stats, want["batch_stats"])
    jax_torch_export._main(["--orbax", path, "--model", "simple_pointnet", "--out",
                            str(tmp_path / "w.pth")])
    cfg = TrainConfig(batch_size=B, num_points=64, **_CONFIGS["sgd-cosine-clip"])
    ds = OrientationDataset.synthetic(samples_per_class=8, num_points=64, class_names=["chair"])
    assert (evaluate(cfg, ds, ckpt=path, device="cpu")
            == evaluate(cfg, ds, torch_ckpt=str(tmp_path / "w.pth"), device="cpu"))


# ---------------------------------------------------------------------------
# the protocols' carry
# ---------------------------------------------------------------------------

class _State:
    """What ``_carry_to_np`` reads of a stacked ``TrainState``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _jax_carry(members: int, seed: int = 8):
    """A stacked ``simple_pointnet`` carry: per member its own weights, an Adam chain
    after one seeded update, a best-val snapshot (member 1's never
    improved: inf, and its best slot holds other weights)."""
    rng = np.random.default_rng(seed)
    trees = [random_flax_variables(seed + i, "simple_pointnet") for i in range(members)]
    tx = optax.chain(optax.adam(LR))
    opts = []
    for t in trees:
        grads = jax.tree_util.tree_map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32),
                                       t["params"])
        opts.append(tree_np(tx.update(grads, tx.init(t["params"]), t["params"])[1]))
    best = [random_flax_variables(seed + 100 + i, "simple_pointnet") for i in range(members)]
    stack = lambda xs: jax.tree_util.tree_map(lambda *a: np.stack(a), *xs)  # noqa: E731
    state = _State(step=np.ones(members, np.int32),
                   params=stack([t["params"] for t in trees]),
                   batch_stats=stack([t["batch_stats"] for t in trees]),
                   opt_state=stack(opts))
    bv = np.asarray([0.5, np.inf, 0.25][:members], np.float32)
    return (state, bv, stack([b["params"] for b in best]),
            stack([b["batch_stats"] for b in best]), np.asarray([2, 0, 3][:members], np.int32))


_PN = 64  # the protocol test's cloud size


def _save_jax_carry(directory, members, keys):
    carry = _jax_carry(members)
    history = {k: {"train": [1.0, 0.5], "val": [0.9, 0.6], "train_ang": [30.0, 20.0],
                   "val_ang": [31.0, 22.0]} for k in keys}
    return jax_pc.save_protocol_checkpoint(directory, 2, carry, history, keys), carry


def test_jax_protocol_carry_reads_restores_and_serves(tmp_path):
    """A multi-seed carry of two members written by the JAX package's
    ``save_protocol_checkpoint``: ``read_pytree`` equals orbax's restore;
    ``restore_protocol_checkpoint`` loads each member (weights, Adam state,
    best-val snapshot, history, epoch); ``from_protocol_checkpoint`` leaves
    out the member whose val never improved and serves the other's best
    weights as the JAX predictor does (sampling "first", the bound of
    tests/test_torch_infer.py)."""
    path, carry = _save_jax_carry(str(tmp_path), 2, [1, 2])
    assert_same_tree(read_pytree(os.path.join(path, "carry")),
                     orbax_restore(os.path.join(path, "carry")))
    trainers = [Trainer(TrainConfig(batch_size=B, num_points=_PN, seed=s, **_CONFIGS[
        "sgd-cosine-clip"]).replace(optimizer="adam", lr_schedule=None, grad_clip=None),
        OrientationDataset.synthetic(**_SMALL_DS), device="cpu") for s in (1, 2)]
    _, history, epoch = PC.restore_protocol_checkpoint(path, trainers, [1, 2])
    assert epoch == 2 and history[2]["val"] == [0.9, 0.6]
    for i, t in enumerate(trainers):
        got = to_flax_variables(t.model)
        assert_same_tree(got["params"], jax.tree_util.tree_map(lambda a: a[i], carry[0].params))
        assert t.epoch == 2 and t.step == 1 and t.history["val"] == [0.9, 0.6]
        assert t.best_val == float(carry[1][i])
        assert t.best_val_epoch == (None if i == 1 else int(carry[4][i]))
        assert {float(s["step"]) for s in t.optimizer.state.values()} == {1.0}
        t.load_best()
        assert_same_tree(to_flax_variables(t.model)["params"],
                         jax.tree_util.tree_map(lambda a: a[i], carry[2]))
    kw = dict(num_points=_PN, max_batch=4)
    clouds = np.random.default_rng(9).normal(size=(3, _PN, 3)).astype(np.float32)
    with pytest.warns(UserWarning, match="non-finite"):
        want = JaxPredictor.from_protocol_checkpoint(path, "simple_pointnet", **kw)
    with pytest.warns(UserWarning, match="non-finite"):
        got = OrientationPredictor.from_protocol_checkpoint(path, "simple_pointnet",
                                                            device="cpu", **kw)
    assert got.ensemble_size == want.ensemble_size == 1
    np.testing.assert_allclose(got(clouds), np.asarray(want(clouds)), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------

def test_committed_fixture_reads_bit_equal_and_serves_as_jax():
    """``tests/data/orbax_transformer`` (``tests/torch_make_orbax_fixture.py``):
    ``read_pytree`` equals orbax's restore and the ``.npz`` bit for bit, and
    ``from_orbax_checkpoint`` serves the JAX predictor's outputs within
    2e-6 (tests/test_torch_point_transformer.py's bound), on both attention
    backends."""
    z = np.load(os.path.join(FIXTURE, "leaves.npz"))
    path = os.path.join(FIXTURE, f"step_{int(z['_step'])}")
    tree = read_pytree(path)
    assert_same_tree(tree, orbax_restore(path))
    leaves = dict(orbax_format.flat_leaves(tree))
    arrays = {k[len("leaf:"):]: z[k] for k in z.files if k.startswith("leaf:")}
    assert sorted(k for k, v in leaves.items() if v is None) == sorted(z["_none_paths"])
    assert set(arrays) == {k for k, v in leaves.items() if v is not None}
    for k, v in arrays.items():
        assert leaves[k].dtype == v.dtype and leaves[k].tobytes() == v.tobytes(), k
    for impl in ("xla", "flash"):
        pred = OrientationPredictor.from_orbax_checkpoint(
            path, "point_transformer", num_points=fixture.N, max_batch=fixture.B,
            attention_impl=impl, device="cpu")
        assert np.abs(pred(z["_clouds"]) - z["_outputs"]).max() <= 2e-6, impl


def read_rate(path: str, reps: int = 5) -> dict:
    """``read_pytree``'s time on the checkpoint at ``path``, the best of
    ``reps`` reads: its zstd frames' compressed and decoded bytes, how many
    carry a content checksum, and the rates."""
    import time

    store = ocdbt.Store(path)
    frames = [v for v in (store.read(k) for k in store.keys()) if v[:4] == b"\x28\xb5\x2f\xfd"]
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        read_pytree(path)
        seconds.append(time.perf_counter() - t0)
    compressed = sum(len(f) for f in frames)
    decoded = sum(len(zstd.decompress(f)) for f in frames)
    best = min(seconds)
    return {"frames": len(frames), "with_checksum": sum(f[4] >> 2 & 1 for f in frames),
            "compressed_bytes": compressed, "decoded_bytes": decoded, "seconds": seconds,
            "compressed_mb_s": compressed / best / 1e6, "decoded_mb_s": decoded / best / 1e6}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_orbax.py
    # prints read_rate() on the full-width 8dir_kl JAX checkpoint of jax_8dir
    # (its moments after an Adam step, as dense as a trained run's) and on the
    # committed fixture: the load path's cost
    import tempfile

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        full = read_rate(_jax_8dir_checkpoint(d)[2])
    step = int(np.load(os.path.join(FIXTURE, "leaves.npz"))["_step"])
    print(json.dumps({"full_width_8dir": full,
                      "fixture": read_rate(os.path.join(FIXTURE, f"step_{step}"))}))
