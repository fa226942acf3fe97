"""Read the reference's PyTorch checkpoints (raw ``state_dict``s of its
PointNet++ family, its point transformer and its PointNet backbones) into
the port.

Counterpart of ``pointcloud_orientation_tpu/utils/torch_import.py``: a
reference ``state_dict`` becomes a flax-layout ``(params, batch_stats)``
tree of numpy arrays, the same tree the JAX package builds, which
:func:`.jax_weights.load_flax_variables` then copies into the port's
modules (:func:`load_reference_state_dict`).

The reference's names: ``sa{1..3}.convs.{i}`` (``Conv2d(Cin, Cout, 1)``,
weight ``(Cout, Cin, 1, 1)``) and ``sa{k}.bns.{i}`` for the set
abstractions, ``fc1``/``fc2`` with ``bn1``/``bn2`` (``ln1``/``ln2`` on the
MvM trunk), then the heads; the transformer's ``input_proj``,
``transformer.layers.{i}`` (``nn.TransformerEncoderLayer``: q, k, v as the
row thirds of ``in_proj_weight``) and ``fc_out``; the PointNet backbones'
``conv{1..3}`` (``Conv1d(Cin, Cout, 1)``, weight ``(Cout, Cin, 1)``),
``bn{i}`` and ``fc{i}``, under the encoder (``encoder`` in
`models/pointnet.py`, ``feat`` in `PointNetDemo.py`) with its ``stn`` and
``fstn``. A ``Linear`` weight ``(out, in)`` is a Dense kernel transposed;
BatchNorm's ``weight``/``bias``/``running_mean``/``running_var`` are
``scale``/``bias`` and ``mean``/``var``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .jax_weights import load_flax_variables

# Head layers per model (reference layer -> flax scope).
HEADS = {
    "pointnet_pp": {"fc3": "Dense_0"},
    "pointnet_pp_8dir": {"fc3": "Dense_0"},
    "pointnet_pp_fwd": {"fc3": "Dense_0"},
    "pointnet_pp_von_mises": {"fc3": "Dense_0"},
    "pointnet_pp_xyz": {"head_x": "head_x", "head_y": "head_y"},
    "pointnet_pp_xyz_schmidt": {"head_y": "head_y", "head_z": "head_z"},
    "pointnet_pp_mvm": {"head_pi": "head_pi", "head_mu": "head_mu", "head_kappa": "head_kappa"},
}
TRANSFORMER = "point_transformer"
# the PointNet backbones, with the reference's attribute of each one's encoder
POINTNET = {"pointnet": "encoder", "pointnet_cls": "feat", "simple_pointnet": None}
_TRUNK = ("PointNetPPTrunk_0",)
_BN_LEAVES = {"weight": (0, "scale"), "bias": (0, "bias"), "running_mean": (1, "mean"),
              "running_var": (1, "var")}


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def import_pointnet_pp_state_dict(state_dict: Mapping[str, Any],
                                  model: str = "pointnet_pp_8dir") -> Tuple[Dict, Dict]:
    """A reference PointNet++-family ``state_dict`` as the ``(params,
    batch_stats)`` trees of ``model``. Raises ``KeyError`` on an entry it
    does not map (``num_batches_tracked`` is dropped)."""
    if model not in HEADS:
        raise ValueError(f"unsupported model for import: {model}")
    params: Dict = {}
    stats: Dict = {}
    mvm = model == "pointnet_pp_mvm"

    def bn(base, leaf, arr):
        if leaf in _BN_LEAVES:
            which, name = _BN_LEAVES[leaf]
            _set((params, stats)[which], base + (name,), arr)

    for name, tensor in state_dict.items():
        arr = _to_np(tensor)
        parts = name.split(".")
        if parts[0].startswith("sa") and len(parts) >= 4:  # sa{k}.convs.{i}.* / sa{k}.bns.{i}.*
            k, i = int(parts[0][2:]) - 1, int(parts[2])
            base = _TRUNK + (f"SetAbstraction_{k}", "SharedMLP_0")
            if parts[1] == "convs":
                if parts[3] == "weight":
                    _set(params, base + (f"Dense_{i}", "kernel"), arr[:, :, 0, 0].T)
                else:
                    _set(params, base + (f"Dense_{i}", "bias"), arr)
            elif parts[1] == "bns":
                bn(base + (f"BatchNorm_{i}",), parts[3], arr)
            continue
        if parts[0] in ("fc1", "fc2"):
            weight = parts[1] == "weight"
            _set(params, _TRUNK + (f"Dense_{int(parts[0][2]) - 1}", "kernel" if weight else "bias"),
                 arr.T if weight else arr)
            continue
        if parts[0] in ("bn1", "bn2") and not mvm:
            bn(_TRUNK + (f"BatchNorm_{int(parts[0][2]) - 1}",), parts[1], arr)
            continue
        if parts[0] in ("ln1", "ln2") and mvm:
            _set(params, _TRUNK + (f"LayerNorm_{int(parts[0][2]) - 1}",
                                   "scale" if parts[1] == "weight" else "bias"), arr)
            continue
        if parts[0] in HEADS[model]:
            weight = parts[1] == "weight"
            _set(params, (HEADS[model][parts[0]], "kernel" if weight else "bias"),
                 arr.T if weight else arr)
            continue
        if parts[-1] == "num_batches_tracked":
            continue
        raise KeyError(f"unmapped state_dict entry: {name}")
    return params, stats


def import_point_transformer_state_dict(state_dict: Mapping[str, Any], num_heads: int = 4
                                        ) -> Tuple[Dict, Dict]:
    """The reference ``PointTransformer``'s ``state_dict`` (Linear 3->E, a
    ``nn.TransformerEncoder`` of post-norm layers, Linear E->3) as the
    flax tree of ``point_transformer``: q, k, v kernels ``(E, H, E/H)``
    (head-major), the out kernel ``(H, E/H, E)``; no ``batch_stats``."""
    params: Dict = {}
    sd = {k: _to_np(v) for k, v in state_dict.items()}

    def dense(path, w, b):
        _set(params, path + ("kernel",), w.T)
        _set(params, path + ("bias",), b)

    dense(("Dense_0",), sd["input_proj.weight"], sd["input_proj.bias"])
    dense(("Dense_1",), sd["fc_out.weight"], sd["fc_out.bias"])
    layers = sorted({int(k.split(".")[2]) for k in sd if k.startswith("transformer.layers.")})
    for i in layers:
        p = f"transformer.layers.{i}."
        lp = (f"TransformerEncoderLayer_{i}",)
        attn = lp + ("MultiHeadDotProductAttention_0",)
        in_w, in_b = sd[p + "self_attn.in_proj_weight"], sd[p + "self_attn.in_proj_bias"]
        width = in_w.shape[1]
        head_dim = width // num_heads
        for j, name in enumerate(("query", "key", "value")):
            rows = slice(j * width, (j + 1) * width)
            _set(params, attn + (name, "kernel"), in_w[rows].T.reshape(width, num_heads, head_dim))
            _set(params, attn + (name, "bias"), in_b[rows].reshape(num_heads, head_dim))
        _set(params, attn + ("out", "kernel"),
             sd[p + "self_attn.out_proj.weight"].T.reshape(num_heads, head_dim, width))
        _set(params, attn + ("out", "bias"), sd[p + "self_attn.out_proj.bias"])
        dense(lp + ("Dense_0",), sd[p + "linear1.weight"], sd[p + "linear1.bias"])
        dense(lp + ("Dense_1",), sd[p + "linear2.weight"], sd[p + "linear2.bias"])
        for t, flax_name in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
            _set(params, lp + (flax_name, "scale"), sd[p + t + ".weight"])
            _set(params, lp + (flax_name, "bias"), sd[p + t + ".bias"])
    return params, {}


def _convert_block(params: Dict, stats: Dict, base: Tuple[str, ...], kind: str, idx: int,
                   leaf: str, arr: np.ndarray) -> None:
    """One reference layer entry under ``base``: ``"conv"`` (a ``Conv1d``
    weight ``(out, in, 1)``) and ``"fc"`` (a ``Linear`` weight ``(out,
    in)``) as ``Dense_{idx}``, ``"bn"`` as ``BatchNorm_{idx}``."""
    if kind in ("conv", "fc"):
        if leaf == "weight":
            kernel = arr[:, :, 0].T if arr.ndim == 3 else arr.T
            _set(params, base + (f"Dense_{idx}", "kernel"), kernel)
        else:
            _set(params, base + (f"Dense_{idx}", "bias"), arr)
    elif leaf in _BN_LEAVES:
        which, name = _BN_LEAVES[leaf]
        _set((params, stats)[which], base + (f"BatchNorm_{idx}", name), arr)


# reference layer -> (kind, flax index) of the STNs, the encoder, the heads
# and SimplePointNet
STN_MAP = {"conv1": ("conv", 0), "conv2": ("conv", 1), "conv3": ("conv", 2),
           "bn1": ("bn", 0), "bn2": ("bn", 1), "bn3": ("bn", 2),
           "fc1": ("fc", 3), "fc2": ("fc", 4), "fc3": ("fc", 5),
           "bn4": ("bn", 3), "bn5": ("bn", 4)}
ENCODER_MAP = {"conv1": ("conv", 0), "conv2": ("conv", 1), "conv3": ("conv", 2),
               "bn1": ("bn", 0), "bn2": ("bn", 1), "bn3": ("bn", 2)}
PN_HEAD_MAP = {"fc1": ("fc", 0), "fc2": ("fc", 1), "fc3": ("fc", 2),
               "bn1": ("bn", 0), "bn2": ("bn", 1)}
SIMPLE_MAP = {"conv1": ("conv", 0), "conv2": ("conv", 1), "conv3": ("conv", 2),
              "bn1": ("bn", 0), "bn2": ("bn", 1), "bn3": ("bn", 2),
              "fc1": ("fc", 3), "bn4": ("bn", 3), "fc2": ("fc", 4)}
# the encoder's transform nets: reference attribute -> flax scope
STNS = {"stn": "STN3d_0", "fstn": "STNkd_0"}


def import_pointnet_state_dict(state_dict: Mapping[str, Any], model: str = "pointnet"
                               ) -> Tuple[Dict, Dict]:
    """A reference PointNet-family ``state_dict`` as the flax ``(params,
    batch_stats)`` of ``model``: ``"pointnet"`` (``PointNet``,
    `models/pointnet.py:111-129`, encoder ``encoder``), ``"pointnet_cls"``
    (``get_model``, `PointNetDemo.py:139-161`, encoder ``feat``) or
    ``"simple_pointnet"`` (`simple_pointnet_train.py:86-113`).
    ``num_batches_tracked`` is dropped; an entry it does not map raises
    ``KeyError``."""
    if model not in POINTNET:
        raise ValueError(f"unsupported model for import: {model}")
    params: Dict = {}
    stats: Dict = {}
    enc_attr = POINTNET[model]
    for name, tensor in state_dict.items():
        arr = _to_np(tensor)
        parts = name.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if model == "simple_pointnet":
            _convert_block(params, stats, (), *SIMPLE_MAP[parts[0]], parts[1], arr)
        elif parts[0] == enc_attr:
            enc = ("PointNetEncoder_0",)
            if parts[1] in STNS:
                _convert_block(params, stats, enc + (STNS[parts[1]],), *STN_MAP[parts[2]],
                               parts[3], arr)
            else:
                _convert_block(params, stats, enc, *ENCODER_MAP[parts[1]], parts[2], arr)
        else:
            _convert_block(params, stats, (), *PN_HEAD_MAP[parts[0]], parts[1], arr)
    return params, stats


def import_state_dict(state_dict: Mapping[str, Any], model: str) -> Tuple[Dict, Dict]:
    """Any supported model's reference ``state_dict`` as its flax trees;
    the JAX package's ``ValueError`` for another (the MoE transformer has no
    reference layout)."""
    if model in HEADS:
        return import_pointnet_pp_state_dict(state_dict, model)
    if model == TRANSFORMER:
        return import_point_transformer_state_dict(state_dict)
    if model in POINTNET:
        return import_pointnet_state_dict(state_dict, model)
    raise ValueError(f"unsupported model for import: {model}")


def load_torch_checkpoint(path: str, model: str = "pointnet_pp_8dir") -> Tuple[Dict, Dict]:
    """Read a reference ``.pth`` (a raw ``state_dict``) and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_state_dict(sd, model)


def load_reference_state_dict(module: nn.Module, state_dict: Mapping[str, Any],
                              model: str) -> nn.Module:
    """Copy a reference ``state_dict`` of ``model`` into the port's
    ``module`` in place (through the flax layout); returns the module."""
    params, stats = import_state_dict(state_dict, model)
    return load_flax_variables(module, {"params": params, "batch_stats": stats})
