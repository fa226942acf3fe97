"""The JAX package's Orbax checkpoints (a ``PyTreeCheckpointer`` directory
such as ``step_<N>/``) read and written with the standard library and
numpy: no ``orbax``, ``tensorstore`` or ``zstandard`` is needed.

A checkpoint directory holds ``_METADATA`` (JSON: each leaf's key path,
each key a dict key (``key_type`` 2) or a sequence index (1), and its
``value_type``), ``_CHECKPOINT_METADATA`` (JSON) and an OCDBT store
(:mod:`.ocdbt`). Each
array leaf is a zarr v2 array in the store under its key path joined by
``.``: ``<name>/.zarray`` (JSON metadata) and one value a chunk,
``<name>/0.0`` and so on (``0`` for a scalar), each chunk its own zstd
frame (:mod:`.zstd`) or raw bytes.

:func:`read_pytree` returns what ``ocp.PyTreeCheckpointer().restore(path)``
returns (a restore without a template): nested dicts for dict keys and
NamedTuple fields, lists for sequences (optax's chain), numpy arrays for
``np.ndarray`` leaves, Python scalars for ``scalar`` leaves, and ``None``,
``{}`` and ``[]`` for the empty nodes (optax's ``EmptyState``, a model
without BatchNorm's statistics). The arrays have the dtypes and bits that
orbax restores. A ``bfloat16`` leaf comes back as an
``ml_dtypes.bfloat16`` array where ``ml_dtypes`` imports (as orbax's), and
otherwise widened exactly to float32 (numpy has no bfloat16).

:func:`write_pytree` writes such a directory from a tree of numpy arrays,
Python scalars, ``None`` and nested dicts and lists, with the chunks
uncompressed (``"compressor": null``): orbax's bare and templated restores
read it, and it is larger on disk than orbax's zstd chunks.

Read: zarr v2 only (``"use_zarr3": true`` raises), OCDBT only (``"use_ocdbt":
false`` raises); dtypes ``<f4 <f8 <f2 <i1..<i8 <u1..<u8 |b1`` and
``bfloat16``; order C; separator ``.``; compressor ``zstd`` or none; no
filters; ``fill_value`` for a missing chunk; arrays in several chunks, edge
chunks cropped. Anything else (another leaf type, compressor, order...)
raises a ``ValueError`` that names it.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from .ocdbt import Store, write_store
from .zstd import decompress

_DICT, _SEQ = 2, 1  # orbax's key types
_HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"


def _bfloat16():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return np.dtype("<u2")  # the bits; converted in _finish_dtype
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"zarr dtype {name!r} is not read") from None
    if dt.kind not in "biuf" or dt.byteorder == ">" or (dt.kind == "f" and dt.itemsize > 8):
        raise ValueError(f"zarr dtype {name!r} is not read (little-endian bool, integer and "
                         "float only, and bfloat16)")
    return dt


def _finish_dtype(arr: np.ndarray, name: str) -> np.ndarray:
    if name != "bfloat16":
        return arr
    bf16 = _bfloat16()
    if bf16 is not None:
        return arr.view(bf16)
    return (arr.astype(np.uint32) << 16).view(np.float32)


def _fill(value, dt: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        special = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}
        if value not in special:
            raise ValueError(f"zarr fill_value {value!r} is not read")
        return special[value]
    return value


def _decode(data: bytes, compressor) -> bytes:
    if compressor is None:
        return data
    if compressor.get("id") == "zstd":
        return decompress(data)
    raise ValueError(f"zarr compressor {compressor.get('id')!r} is not read (zstd or none)")


def read_array(store: Store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of an OCDBT :class:`.ocdbt.Store`."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')!r}; only 2 is read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']!r} are not read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr order {meta['order']!r} is not read (C only)")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{name}: zarr dimension_separator {meta['dimension_separator']!r} is "
                         "not read ('.' only)")
    dt = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunks {list(chunks)} do not fit shape {list(shape)}")
    out = np.full(shape, _fill(meta.get("fill_value"), dt), dtype=dt)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue
        raw = _decode(store.read(key), meta.get("compressor"))
        if len(raw) != dt.itemsize * math.prod(chunks):
            raise ValueError(f"{key}: {len(raw)} bytes for a chunk of {list(chunks)} {dt}")
        chunk = np.frombuffer(raw, dt).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return _finish_dtype(out, meta["dtype"])


def _metadata(path: str) -> Dict:
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        raise ValueError(f"{path} has no _METADATA (not an Orbax PyTree checkpoint)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path} keeps its arrays in zarr3 (use_zarr3: true); only zarr v2 "
                         "is read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path} keeps its arrays outside an OCDBT store (use_ocdbt: false); "
                         "only OCDBT checkpoints are read")
    return meta


def _assemble(node):
    """The nested (key, value) pairs gathered by :func:`read_pytree` as dicts
    and lists."""
    if not isinstance(node, _Node):
        return node
    if node.kind == _SEQ:
        items = sorted(node.children.items(), key=lambda kv: int(kv[0]))
        if [int(k) for k, _ in items] != list(range(len(items))):
            raise ValueError(f"sequence indices {[k for k, _ in items]} are not 0..n-1")
        return [_assemble(v) for _, v in items]
    return {k: _assemble(v) for k, v in node.children.items()}


class _Node:
    __slots__ = ("kind", "children")

    def __init__(self, kind: int):
        self.kind, self.children = kind, {}


def read_pytree(path: str) -> Any:
    """The tree of the Orbax PyTree checkpoint at ``path`` (module
    docstring), as orbax's bare restore gives it."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    store = Store(path)
    root = None
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        vtype = entry["value_metadata"]["value_type"]
        name = ".".join(str(k["key"]) for k in keys)
        if vtype == "np.ndarray":
            value = read_array(store, name)
        elif vtype == "scalar":
            value = read_array(store, name).item()
        elif vtype == "None":
            value = None
        elif vtype == "Dict":
            value = {}
        elif vtype == "List":
            value = []
        else:
            raise ValueError(f"{path}: leaf {name!r} has value_type {vtype!r}, which is not read")
        if not keys:
            raise ValueError(f"{path}: a leaf with an empty key path")
        if root is None:
            root = _Node(keys[0]["key_type"])
        node = root
        for k, nxt in zip(keys, keys[1:] + [None]):
            if k["key_type"] not in (_DICT, _SEQ) or node.kind != k["key_type"]:
                raise ValueError(f"{path}: leaf {name!r} has key type {k['key_type']!r} where "
                                 f"its tree has {node.kind!r}")
            if nxt is None:
                node.children[str(k["key"])] = value
            else:
                node = node.children.setdefault(str(k["key"]), _Node(nxt["key_type"]))
    if root is None:
        raise ValueError(f"{path}: _METADATA lists no leaf")
    return _assemble(root)


def flat_leaves(tree: Any, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """``("a/b/c", leaf)`` pairs of a restored tree (dicts and lists), in
    the tree's order: the keys of the fixture's ``leaves.npz``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return [("/".join(prefix), tree)]
    return [pair for k, v in items for pair in flat_leaves(v, prefix + (str(k),))]


# ---------- writing ----------

def _flatten(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs; a key is ``(key, key_type)``."""
    if isinstance(tree, dict):
        if not tree:
            return [(path, {})]
        out = []
        for k in sorted(tree, key=str):
            out += _flatten(tree[k], path + ((str(k), _DICT),))
        return out
    if isinstance(tree, (list, tuple)):
        if not tree:
            return [(path, [])]
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + ((str(i), _SEQ),))
        return out
    return [(path, tree)]


def _zarr_dtype(dt: np.dtype) -> str:
    if dt.name == "bfloat16":
        return "bfloat16"
    if dt.kind not in "biuf":
        raise ValueError(f"dtype {dt} is not written (bool, integer and float only)")
    return dt.newbyteorder("<").str if dt.itemsize > 1 else dt.str


def write_pytree(path: str, tree: Any) -> str:
    """Write ``tree`` (nested dicts, lists and tuples of numpy arrays,
    Python or numpy scalars, ``None``, ``{}`` and ``[]``) as an Orbax
    PyTree checkpoint at ``path``, replacing what is there: arrays and
    numpy scalars as ``np.ndarray`` leaves, Python ``bool``/``int``/
    ``float`` as ``scalar`` leaves, each in one uncompressed chunk. The
    directory is built beside ``path`` and renamed into place. Returns
    ``path``."""
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{time.time_ns()}"
    os.makedirs(tmp)
    init = time.time_ns()
    items: Dict[str, bytes] = {}
    tree_meta: Dict[str, Dict] = {}
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("the tree must be a dict or a sequence, not a bare leaf")
        name = ".".join(k for k, _ in keys)
        if leaf is None or (isinstance(leaf, (dict, list)) and not leaf):
            vtype, skip = {type(None): "None", dict: "Dict", list: "List"}[type(leaf)], True
        else:
            skip = False
            if isinstance(leaf, (bool, int, float)):
                vtype, arr = "scalar", np.asarray(leaf)
            else:
                vtype, arr = "np.ndarray", np.asarray(leaf)
            shape = list(arr.shape)
            items[f"{name}/.zarray"] = json.dumps(
                {"chunks": shape, "compressor": None, "dimension_separator": ".",
                 "dtype": _zarr_dtype(arr.dtype), "fill_value": None, "filters": None,
                 "order": "C", "shape": shape, "zarr_format": 2},
                sort_keys=True, separators=(",", ":")).encode()
            chunk = ".".join("0" for _ in shape) or "0"
            data = np.ascontiguousarray(arr)
            if data.dtype.byteorder == ">":
                data = data.astype(data.dtype.newbyteorder("<"))
            items[f"{name}/{chunk}"] = data.tobytes()
        key = "(" + ", ".join(repr(k) for k, _ in keys) + ("," if len(keys) == 1 else "") + ")"
        tree_meta[key] = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                          "value_metadata": {"value_type": vtype, "skip_deserialize": skip}}
    write_store(tmp, items)
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path
