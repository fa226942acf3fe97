"""Carry the JAX package's flax variables into the port, and make such a
variable tree with numpy alone, for the models of the port: the PointNet++
yaw heads (``PointNetPP8Dir``, ``PointNetPPFwd``, ``PointNetPPVonMises``,
``PointNetPPMvM``), the SO(3) heads (``PointNetPP``, ``PointNetPPXYZ``,
``PointNetPPXYZSchmidt``), the classifier (``PointNetPPCls``), the point
transformer (``PointTransformer``) and its MoE variant
(``MoEPointTransformer``), and the PointNet backbones (``SimplePointNet``,
``PointNet``, ``PointNetCls``).

A tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
arrays (or anything ``np.asarray`` takes) under flax's names. A flax Dense
``kernel`` is ``(Cin, Cout)``, the transpose of ``nn.Linear.weight``; the
attention's ``query``/``key``/``value`` kernels are ``(E, H, D)`` with
biases ``(H, D)`` and its ``out`` kernel ``(H, D, E)``, the same numbers as
the Linear's flattened (the sequence-parallel ``RingPointTransformer``'s
``qkv`` kernel is ``(E, 3, H, D)``, bias ``(3, H, D)``). BatchNorm has
``scale``/``bias`` params and
``mean``/``var`` statistics, LayerNorm (the MvM trunk's funnel, the
transformer) ``scale``/``bias`` params only; the transformers have no
``batch_stats``. The MoE layer's ``MoEFeedForward_0`` holds a ``router``
Dense without bias (``kernel (E, K)``) and the experts' stacked ``wi (K, E,
F)``, ``bi (K, F)``, ``wo (K, F, E)``, ``bo (K, E)``, the port's parameters
as they are.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.moe_transformer import MoEPointTransformer
from ..models.point_transformer import PointTransformer
from ..models.pointnet import PointNet, PointNetCls, PointNetEncoder, _PointNetHead, _STN
from ..models.pointnet_pp import (
    PointNetPPCls,
    PointNetPPMvM,
    PointNetPPXYZ,
    PointNetPPXYZSchmidt,
    mu_bias_init,
)
from ..models.simple_pointnet import SimplePointNet
from ..parallel.sp_transformer import RingPointTransformer

# MLP widths of each set abstraction (the grouped input width is 3 plus the
# previous stage's output, or plus the cloud's features for the first)
_SA_WIDTHS = ((64, 64, 128), (128, 128, 256), (256, 512, 1024))
_FC_WIDTHS = ((1024, 512), (512, 256))
_TRUNK = ("PointNetPPTrunk_0",)
# the classifier's set-abstraction scopes sit at the top of its tree, the
# other models' under their trunk
_SCOPE = {"pointnet_pp_8dir": _TRUNK, "pointnet_pp_fwd": _TRUNK,
          "pointnet_pp_von_mises": _TRUNK, "pointnet_pp_mvm": _TRUNK, "pointnet_pp_cls": (),
          "pointnet_pp": _TRUNK, "pointnet_pp_xyz": _TRUNK, "pointnet_pp_xyz_schmidt": _TRUNK,
          "point_transformer": (), "moe_point_transformer": (), "ring_point_transformer": ()}
# the PointNet backbones: their flax trees are read off the port's module
# (:func:`_pointnet_pairs`), not written out here
POINTNET_MODELS = {"simple_pointnet": SimplePointNet, "pointnet": PointNet,
                   "pointnet_cls": PointNetCls}
_MHA = "MultiHeadDotProductAttention_0"
_MVM_HEADS = ("head_pi", "head_mu", "head_kappa")
# the two-axis heads' Dense scopes, each 3 wide
_AXES_HEADS = {"pointnet_pp_xyz": PointNetPPXYZ.HEADS,
               "pointnet_pp_xyz_schmidt": PointNetPPXYZSchmidt.HEADS}


def _attention_pairs(scope: Tuple[str, ...], attn) -> Iterator[Tuple]:
    heads, width = attn.num_heads, attn.query.out_features
    qkv = ((width, heads, width // heads), (heads, width // heads))
    for name in ("query", "key", "value"):
        yield scope + (_MHA, name), getattr(attn, name), None, None, qkv
    yield (scope + (_MHA, "out"), attn.out, None, None,
           ((heads, width // heads, width), (width,)))


def _transformer_pairs(model: PointTransformer) -> Iterator[Tuple]:
    yield ("Dense_0",), model.embed, None, None, None
    for i, layer in enumerate(model.layers):
        scope = (f"TransformerEncoderLayer_{i}",)
        yield from _attention_pairs(scope, layer.attn)
        yield scope + ("Dense_0",), layer.ffn1, scope + ("LayerNorm_0",), layer.ln1, None
        yield scope + ("Dense_1",), layer.ffn2, scope + ("LayerNorm_1",), layer.ln2, None
    yield ("Dense_1",), model.head, None, None, None


def _ring_pairs(model: RingPointTransformer) -> Iterator[Tuple]:
    """The sequence-parallel transformer's Dense layers: ``layer_i`` holds
    ``RingSelfAttention_0`` (``qkv`` to ``(3, H, D)``, ``out``), then
    ``Dense_0``/``Dense_1`` paired with ``LayerNorm_0``/``LayerNorm_1``."""
    yield ("Dense_0",), model.embed, None, None, None
    for i, layer in enumerate(model.layers):
        scope = (f"layer_{i}",)
        attn = layer.attn
        width, heads = attn.out.in_features, attn.num_heads
        yield (scope + ("RingSelfAttention_0", "qkv"), attn.qkv, None, None,
               ((width, 3, heads, width // heads), (3, heads, width // heads)))
        yield scope + ("RingSelfAttention_0", "out"), attn.out, None, None, None
        yield scope + ("Dense_0",), layer.ffn1, scope + ("LayerNorm_0",), layer.ln1, None
        yield scope + ("Dense_1",), layer.ffn2, scope + ("LayerNorm_1",), layer.ln2, None
    yield ("Dense_1",), model.head, None, None, None


def _moe_pairs(model: MoEPointTransformer) -> Iterator[Tuple]:
    """The MoE transformer's Dense layers, the two LayerNorms of a layer
    paired with its router (no bias) and its attention's ``out``."""
    yield ("Dense_0",), model.embed, None, None, None
    for i, layer in enumerate(model.layers):
        scope = (f"MoETransformerEncoderLayer_{i}",)
        *qkv, (out_path, out, _, _, out_shapes) = _attention_pairs(scope, layer.attn)
        yield from qkv
        yield out_path, out, scope + ("LayerNorm_0",), layer.ln1, out_shapes
        yield (scope + ("MoEFeedForward_0", "router"), layer.moe.router,
               scope + ("LayerNorm_1",), layer.ln2, None)
    yield ("Dense_1",), model.head, None, None, None


def _expert_leaves(model: nn.Module) -> Iterator[Tuple[Tuple[str, ...], Dict]]:
    """The MoE layers' stacked expert parameters by their flax scope:
    ``{"wi", "bi", "wo", "bo"}``, the same arrays in both layouts."""
    if isinstance(model, MoEPointTransformer):
        for i, layer in enumerate(model.layers):
            moe = layer.moe
            yield ((f"MoETransformerEncoderLayer_{i}", "MoEFeedForward_0"),
                   {"wi": moe.wi, "bi": moe.bi, "wo": moe.wo, "bo": moe.bo})


def _dense_bn(scope: Tuple[str, ...], blocks) -> Iterator[Tuple]:
    """The ``DenseBN`` blocks in order as flax's auto-named ``Dense_i`` and
    ``BatchNorm_i`` under ``scope``."""
    for i, block in enumerate(blocks):
        yield scope + (f"Dense_{i}",), block.lin, scope + (f"BatchNorm_{i}",), block.bn, None


def _pointnet_pairs(model: nn.Module) -> Iterator[Tuple]:
    """The PointNet backbones' layers under flax's auto-names: an STN's
    ``Dense_0..5`` (its three pointwise and three FC layers) and
    ``BatchNorm_0..4``; the encoder's ``STN3d_0``, ``STNkd_0`` and its
    ``Dense_0..2``/``BatchNorm_0..2``; a head's ``PointNetEncoder_0``,
    ``Dense_0..2`` and ``BatchNorm_0..1``; ``SimplePointNet``'s
    ``Dense_0..4`` and ``BatchNorm_0..3``."""
    if isinstance(model, SimplePointNet):
        yield from _dense_bn((), (model.conv1, model.conv2, model.conv3, model.fc1))
        yield ("Dense_4",), model.fc2, None, None, None
        return

    def stn(scope, m: _STN):
        yield from _dense_bn(scope, (m.conv1, m.conv2, m.conv3, m.fc1, m.fc2))
        yield scope + ("Dense_5",), m.fc3, None, None, None

    enc: PointNetEncoder = model.encoder
    top = ("PointNetEncoder_0",)
    yield from stn(top + ("STN3d_0",), enc.stn)
    if enc.fstn is not None:
        yield from stn(top + ("STNkd_0",), enc.fstn)
    yield from _dense_bn(top, (enc.conv1, enc.conv2, enc.conv3))
    yield ("Dense_0",), model.fc1.lin, ("BatchNorm_0",), model.fc1.bn, None
    yield ("Dense_1",), model.fc2, ("BatchNorm_1",), model.bn2, None
    yield ("Dense_2",), model.fc3, None, None, None


def _pairs(model: nn.Module) -> Iterator[Tuple]:
    """(Dense scope, Linear, norm scope, norm module, flax shapes) for every
    layer of the model, the norm None for a layer without one; the norm is
    a BatchNorm1d or a LayerNorm (the MvM trunk's funnel, the transformer).
    The flax shapes are the (kernel, bias) shapes of an attention Dense,
    None for a plain Dense."""
    if isinstance(model, PointTransformer):
        yield from _transformer_pairs(model)
        return
    if isinstance(model, MoEPointTransformer):
        yield from _moe_pairs(model)
        return
    if isinstance(model, RingPointTransformer):
        yield from _ring_pairs(model)
        return
    if isinstance(model, (SimplePointNet, _PointNetHead)):
        yield from _pointnet_pairs(model)
        return
    if isinstance(model, PointNetPPCls):
        top, sas = (), (model.sa1, model.sa2, model.sa3)
        fcs = ((model.fc1, model.bn1), (model.fc2, model.bn2))
    else:
        trunk = model.trunk
        top, sas = _TRUNK, (trunk.sa1, trunk.sa2, trunk.sa3)
        if trunk.fc_norm == "layer":
            fcs = ((trunk.fc1, trunk.ln1), (trunk.fc2, trunk.ln2))
        else:
            fcs = ((trunk.fc1, trunk.bn1), (trunk.fc2, trunk.bn2))
    for i, sa in enumerate(sas):
        for j, (lin, bn) in enumerate(zip(sa.mlp.linears, sa.mlp.bns)):
            scope = top + (f"SetAbstraction_{i}", "SharedMLP_0")
            yield scope + (f"Dense_{j}",), lin, scope + (f"BatchNorm_{j}",), bn, None
    for j, (lin, norm) in enumerate(fcs):
        kind = "LayerNorm" if isinstance(norm, nn.LayerNorm) else "BatchNorm"
        yield top + (f"Dense_{j}",), lin, top + (f"{kind}_{j}",), norm, None
    if isinstance(model, PointNetPPCls):
        yield ("Dense_2",), model.fc3, None, None, None
    elif isinstance(model, (PointNetPPMvM, PointNetPPXYZ)):
        for name in _MVM_HEADS if isinstance(model, PointNetPPMvM) else model.HEADS:
            yield (name,), getattr(model, name), None, None, None
    else:
        yield ("Dense_0",), model.head, None, None, None


def cls_kwargs(params: Dict) -> Dict[str, int]:
    """``PointNetPPCls`` constructor arguments read from a flax ``params``
    tree: ``in_channels`` (3, or 6 with normals) from the first Dense of
    the first set abstraction, ``num_classes`` from the output Dense."""
    first = _get(params, ("SetAbstraction_0", "SharedMLP_0", "Dense_0"), "params")
    last = _get(params, ("Dense_2",), "params")
    return {"in_channels": int(np.shape(first["kernel"])[0]),
            "num_classes": int(np.shape(last["kernel"])[1])}


def _get(tree: Dict, path: Tuple[str, ...], what: str) -> Dict:
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"{what} has no {'/'.join(path)}")
        node = node[key]
    return node


def _copy(dst: torch.Tensor, src, name: str) -> None:
    arr = np.asarray(src, dtype=np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {arr.shape}, the model expects {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr, copy=True)))


def load_flax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Copy a flax ``{"params", "batch_stats"}`` tree of the JAX package's
    model of the same kind into the port's ``model`` in place; returns the
    model. Raises on a missing entry or a shape that does not match (for
    the classifier, build the model with :func:`cls_kwargs` of the tree;
    for the vM head, with the ``mu_parameterization`` whose head width the
    tree has)."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    for lin_path, lin, norm_path, norm, shapes in _pairs(model):
        dense = _get(params, lin_path, "params")
        name = "/".join(lin_path)
        kernel = np.asarray(dense["kernel"])
        bias = None if lin.bias is None else np.asarray(dense["bias"])
        if shapes is not None:  # an attention Dense: check its flax shapes, then flatten
            for what, arr, shape in (("kernel", kernel, shapes[0]), ("bias", bias, shapes[1])):
                if arr.shape != shape:
                    raise ValueError(f"{name}/{what}: shape {arr.shape}, the model expects "
                                     f"{shape}")
            kernel, bias = kernel.reshape(lin.in_features, -1), bias.reshape(-1)
        _copy(lin.weight, kernel.T, name + "/kernel")
        if bias is not None:
            _copy(lin.bias, bias, name + "/bias")
        if norm is None:
            continue
        p = _get(params, norm_path, "params")
        name = "/".join(norm_path)
        _copy(norm.weight, p["scale"], name + "/scale")
        _copy(norm.bias, p["bias"], name + "/bias")
        if isinstance(norm, nn.LayerNorm):
            continue
        if stats is None:
            raise KeyError("variables has no batch_stats; the model's BatchNorm needs them")
        st = _get(stats, norm_path, "batch_stats")
        _copy(norm.running_mean, st["mean"], name + "/mean")
        _copy(norm.running_var, st["var"], name + "/var")
    for path, leaves in _expert_leaves(model):
        tree = _get(params, path, "params")
        for leaf, p in leaves.items():
            _copy(p, tree[leaf], "/".join(path + (leaf,)))
    return model


def _set(tree: Dict, path: Tuple[str, ...], value: Dict) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _np(t: torch.Tensor, name: str) -> np.ndarray:
    if t is None:
        raise ValueError(f"{name} has no gradient")
    return t.detach().cpu().numpy().copy()


def to_flax_variables(model: nn.Module, grads: bool = False) -> Dict:
    """The model's weights and running statistics as a flax
    ``{"params", "batch_stats"}`` tree of numpy arrays in the JAX package's
    layout (the inverse of :func:`load_flax_variables`; ``batch_stats`` is
    empty for a model without BatchNorm). With ``grads=True``,
    ``{"params": ...}`` holds the parameters' ``.grad`` instead, so that a
    step's gradients compare leaf by leaf with ``jax.grad``'s."""
    params: Dict = {}
    stats: Dict = {}

    def value(p: torch.Tensor, name: str) -> np.ndarray:
        return _np(p.grad if grads else p, name)

    for lin_path, lin, norm_path, norm, shapes in _pairs(model):
        name = "/".join(lin_path)
        kernel = value(lin.weight, name + "/kernel").T.copy()
        if lin.bias is None:  # the MoE router
            _set(params, lin_path, {"kernel": kernel})
        else:
            bias = value(lin.bias, name + "/bias")
            if shapes is not None:
                kernel, bias = kernel.reshape(shapes[0]), bias.reshape(shapes[1])
            _set(params, lin_path, {"kernel": kernel, "bias": bias})
        if norm is None:
            continue
        name = "/".join(norm_path)
        _set(params, norm_path, {"scale": value(norm.weight, name + "/scale"),
                                 "bias": value(norm.bias, name + "/bias")})
        if not isinstance(norm, nn.LayerNorm):
            _set(stats, norm_path, {"mean": _np(norm.running_mean, name + "/mean"),
                                    "var": _np(norm.running_var, name + "/var")})
    for path, leaves in _expert_leaves(model):  # beside the router, set above
        _get(params, path, "params").update(
            {leaf: value(p, "/".join(path + (leaf,))) for leaf, p in leaves.items()})
    return {"params": params} if grads else {"params": params, "batch_stats": stats}


def flax_parameter_paths(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...],
                                                                 str]]:
    """Each parameter of ``model`` by its name: ``(flax path, flax shape,
    kind)``, the path ending in the leaf's name (``kernel``, ``bias``,
    ``scale``, ``wi``...), ``kind`` ``"kernel"`` for an ``nn.Linear``
    weight (the flax kernel transposed, then reshaped) and ``"plain"`` for
    the rest (reshaped only). :func:`to_flax_layout` and
    :func:`from_flax_layout` turn a tensor between the two layouts."""
    names = {id(p): n for n, p in model.named_parameters()}
    out: Dict = {}
    for lin_path, lin, norm_path, norm, shapes in _pairs(model):
        kernel, bias = shapes or ((lin.in_features, lin.out_features), (lin.out_features,))
        out[names[id(lin.weight)]] = (lin_path + ("kernel",), tuple(kernel), "kernel")
        if lin.bias is not None:
            out[names[id(lin.bias)]] = (lin_path + ("bias",), tuple(bias), "plain")
        if norm is not None:
            for leaf, p in (("scale", norm.weight), ("bias", norm.bias)):
                out[names[id(p)]] = (norm_path + (leaf,), tuple(p.shape), "plain")
    for path, leaves in _expert_leaves(model):
        for leaf, p in leaves.items():
            out[names[id(p)]] = (path + (leaf,), tuple(p.shape), "plain")
    return out


def to_flax_layout(t: torch.Tensor, shape: Tuple[int, ...], kind: str) -> torch.Tensor:
    """A parameter tensor in its flax leaf's layout (:func:`flax_parameter_paths`)."""
    return (t.t() if kind == "kernel" else t).reshape(shape)


def from_flax_layout(t: torch.Tensor, torch_shape: Tuple[int, ...], kind: str) -> torch.Tensor:
    """The inverse of :func:`to_flax_layout` for a parameter of ``torch_shape``."""
    if kind == "kernel":
        return t.reshape(torch_shape[1], torch_shape[0]).t()
    return t.reshape(torch_shape)


def ring_kwargs(params: Dict) -> Dict[str, int]:
    """``RingPointTransformer`` constructor arguments read from a flax
    ``params`` tree: ``in_dim`` and ``embed_dim`` from the embedding,
    ``depth`` from the ``layer_i`` count, ``num_heads`` from the first
    ``qkv`` kernel ``(E, 3, H, D)``, ``ffn_dim`` from its ``Dense_0``."""
    embed = np.shape(_get(params, ("Dense_0",), "params")["kernel"])
    depth = 0
    while f"layer_{depth}" in params:
        depth += 1
    if depth == 0:
        raise KeyError("params has no layer_0")
    qkv = np.shape(_get(params, ("layer_0", "RingSelfAttention_0", "qkv"), "params")["kernel"])
    ffn = np.shape(_get(params, ("layer_0", "Dense_0"), "params")["kernel"])
    return {"in_dim": int(embed[0]), "embed_dim": int(embed[1]), "depth": depth,
            "num_heads": int(qkv[2]), "ffn_dim": int(ffn[1])}


def kernel_parameters(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """Each Dense kernel of ``model``'s flax tree by its ``/``-joined path
    (``.../Dense_0/kernel``, the key of :mod:`.quantize`'s scales): the name
    of the ``nn.Linear`` weight that holds it in the port's module and that
    Linear's ``in_features`` (a kernel reshaped to ``(in_features, -1)`` and
    transposed is the weight)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {"/".join(lin_path + ("kernel",)): (names[id(lin.weight)], lin.in_features)
            for lin_path, lin, _, _, _ in _pairs(model)}


def transformer_kwargs(params: Dict, moe: bool = False) -> Dict[str, int]:
    """``PointTransformer`` (or, with ``moe``, ``MoEPointTransformer``)
    constructor arguments read from a flax ``params`` tree: ``in_dim`` and
    ``embed_dim`` from the embedding Dense, ``depth`` from the layers'
    count, ``num_heads`` from the first layer's query kernel ``(E, H, D)``,
    ``ffn_dim`` from its first feed-forward Dense (the MoE layer's ``wi (K,
    E, F)``, which also gives ``n_experts``)."""
    layer = "MoETransformerEncoderLayer" if moe else "TransformerEncoderLayer"
    embed = np.shape(_get(params, ("Dense_0",), "params")["kernel"])
    depth = 0
    while f"{layer}_{depth}" in params:
        depth += 1
    if depth == 0:
        raise KeyError(f"params has no {layer}_0")
    first = (f"{layer}_0",)
    query = np.shape(_get(params, first + (_MHA, "query"), "params")["kernel"])
    out = {"in_dim": int(embed[0]), "embed_dim": int(embed[1]), "depth": depth,
           "num_heads": int(query[1])}
    if moe:
        wi = np.shape(_get(params, first + ("MoEFeedForward_0",), "params")["wi"])
        return {**out, "ffn_dim": int(wi[2]), "n_experts": int(wi[0])}
    ffn = np.shape(_get(params, first + ("Dense_0",), "params")["kernel"])
    return {**out, "ffn_dim": int(ffn[1])}


def pointnet_kwargs(model: str, params: Dict) -> Dict:
    """Constructor arguments of a PointNet backbone read from its flax
    ``params`` tree: ``in_channels`` from the first Dense (the input
    transform's for ``pointnet``/``pointnet_cls``), ``num_classes`` from
    ``pointnet_cls``'s output Dense, ``feature_transform`` from whether
    ``pointnet``'s encoder has ``STNkd_0``."""
    if model == "simple_pointnet":
        return {"in_channels": int(np.shape(_get(params, ("Dense_0",), "params")["kernel"])[0])}
    enc = _get(params, ("PointNetEncoder_0",), "params")
    first = _get(enc, ("STN3d_0", "Dense_0"), "params")
    out = {"in_channels": int(np.shape(first["kernel"])[0])}
    if model == "pointnet_cls":
        out["num_classes"] = int(np.shape(_get(params, ("Dense_2",), "params")["kernel"])[1])
    else:
        out["feature_transform"] = "STNkd_0" in enc
    return out


def model_kwargs(model: str, params: Dict) -> Dict:
    """Constructor arguments of the port's ``model`` that its flax tree
    fixes: the classifier's :func:`cls_kwargs`, the transformer's
    :func:`transformer_kwargs` (the MoE transformer's too), the PointNet backbones'
    :func:`pointnet_kwargs`, the vM head's ``mu_parameterization`` (the
    tanh head is 2 wide, the atan2 head 3), the MvM head's ``max_K``; none
    for the others (the two-axis heads' ``gram_schmidt`` and
    ``normalize_heads`` are not in the tree)."""
    if model == "pointnet_pp_cls":
        return cls_kwargs(params)
    if model in POINTNET_MODELS:
        return pointnet_kwargs(model, params)
    if model in ("point_transformer", "moe_point_transformer"):
        return transformer_kwargs(params, moe=model == "moe_point_transformer")
    if model == "ring_point_transformer":
        return ring_kwargs(params)
    if model == "pointnet_pp_von_mises":
        width = np.shape(_get(params, ("Dense_0",), "params")["kernel"])[1]
        return {"mu_parameterization": "atan2" if width == 3 else "tanh"}
    if model == "pointnet_pp_mvm":
        return {"max_K": int(np.shape(_get(params, ("head_pi",), "params")["kernel"])[1])}
    return {}


def random_flax_variables(seed: int, model: str = "pointnet_pp_8dir", in_channels: int = 3,
                          num_classes: int = 40, mu_parameterization: str = "tanh",
                          max_K: int = 4, mu_init: str = "zero", embed_dim: int = 64,
                          num_heads: int = 4, depth: Optional[int] = None,
                          ffn_dim: Optional[int] = None, n_experts: int = 4) -> Dict:
    """A variable tree of the JAX package's ``model`` in its layout, made
    with numpy from ``seed``: LeCun-normal kernels, small random biases,
    BatchNorm with random scale, shift, mean and variance (var in [0.5,
    1.5]), so that folding BatchNorm into the kernels is exercised, and
    LayerNorm with random scale and shift. ``pointnet_pp_cls`` takes
    ``in_channels`` 3 or 6 and ``num_classes``; ``pointnet_pp_von_mises``
    its ``mu_parameterization`` (a head 2 or 3 wide); ``pointnet_pp_mvm``
    ``max_K`` and ``mu_init`` (``"spread"``: ``head_mu``'s bias is the
    spread initialisation, the unit vectors at ``2 pi k / max_K``);
    ``point_transformer`` ``in_channels`` (its ``in_dim``), ``embed_dim``,
    ``num_heads``, ``depth`` and ``ffn_dim``, with no ``batch_stats``, and
    ``moe_point_transformer`` the same and ``n_experts`` (random expert
    biases, so that an empty capacity slot's bias output would show);
    ``ring_point_transformer`` ``in_channels``, ``embed_dim``,
    ``num_heads``, ``depth`` and ``ffn_dim`` (each model's own defaults
    where None: depth 6 and ffn_dim 2,048 for the transformers, 2 and 256
    for the ring model);
    ``simple_pointnet`` and ``pointnet`` ``in_channels``; ``pointnet_cls``
    ``in_channels`` and ``num_classes``."""
    if model not in _SCOPE and model not in POINTNET_MODELS:
        raise NotImplementedError(
            f"model {model!r}: the port has {sorted([*_SCOPE, *POINTNET_MODELS])}")
    ring = model == "ring_point_transformer"
    depth = (2 if ring else 6) if depth is None else depth
    ffn_dim = (256 if ring else 2048) if ffn_dim is None else ffn_dim
    rng = np.random.default_rng(seed)
    params: Dict = {}
    stats: Dict = {}

    def dense(path, cin, cout):
        _set(params, path, {
            "kernel": (rng.standard_normal((cin, cout)) / np.sqrt(cin)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32),
        })

    def norm(path, c, running_stats=True):
        _set(params, path, {
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
        })
        if running_stats:
            _set(stats, path, {
                "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
            })

    if model in POINTNET_MODELS:
        kw = {"in_channels": in_channels}
        if model == "pointnet_cls":
            kw["num_classes"] = num_classes
        for lin_path, lin, bn_path, bn, _ in _pairs(POINTNET_MODELS[model](**kw)):
            dense(lin_path, lin.in_features, lin.out_features)
            if bn is not None:
                norm(bn_path, bn.num_features)
        return {"params": params, "batch_stats": stats}
    if ring:
        template = RingPointTransformer(in_channels, embed_dim, num_heads, depth, ffn_dim)
        for lin_path, lin, ln_path, ln, shapes in _pairs(template):
            dense(lin_path, lin.in_features, lin.out_features)
            if shapes is not None:
                p = _get(params, lin_path, "params")
                p["kernel"] = p["kernel"].reshape(shapes[0])
                p["bias"] = p["bias"].reshape(shapes[1])
            if ln is not None:
                norm(ln_path, ln.normalized_shape[0], running_stats=False)
        return {"params": params, "batch_stats": stats}
    top = _SCOPE[model]
    if model in ("point_transformer", "moe_point_transformer"):
        moe = model == "moe_point_transformer"
        head_dim = embed_dim // num_heads
        dense(("Dense_0",), in_channels, embed_dim)
        for i in range(depth):
            scope = (f"{'MoE' if moe else ''}TransformerEncoderLayer_{i}",)
            for name in ("query", "key", "value", "out"):
                dense(scope + (_MHA, name), embed_dim, embed_dim)
                p = params[scope[0]][_MHA][name]
                if name == "out":
                    p["kernel"] = p["kernel"].reshape(num_heads, head_dim, embed_dim)
                else:
                    p["kernel"] = p["kernel"].reshape(embed_dim, num_heads, head_dim)
                    p["bias"] = p["bias"].reshape(num_heads, head_dim)
            if moe:
                K, E, F = n_experts, embed_dim, ffn_dim
                _set(params, scope + ("MoEFeedForward_0",), {
                    "router": {"kernel": (rng.standard_normal((E, K)) / np.sqrt(E))
                               .astype(np.float32)},
                    "wi": (rng.standard_normal((K, E, F)) / np.sqrt(E)).astype(np.float32),
                    "bi": (0.1 * rng.standard_normal((K, F))).astype(np.float32),
                    "wo": (rng.standard_normal((K, F, E)) / np.sqrt(F)).astype(np.float32),
                    "bo": (0.1 * rng.standard_normal((K, E))).astype(np.float32)})
            else:
                dense(scope + ("Dense_0",), embed_dim, ffn_dim)
                dense(scope + ("Dense_1",), ffn_dim, embed_dim)
            norm(scope + ("LayerNorm_0",), embed_dim, running_stats=False)
            norm(scope + ("LayerNorm_1",), embed_dim, running_stats=False)
        dense(("Dense_1",), embed_dim, 3)
        return {"params": params, "batch_stats": stats}
    cin = in_channels if model == "pointnet_pp_cls" else 3
    for i, widths in enumerate(_SA_WIDTHS):
        scope = top + (f"SetAbstraction_{i}", "SharedMLP_0")
        for j, cout in enumerate(widths):
            dense(scope + (f"Dense_{j}",), cin, cout)
            norm(scope + (f"BatchNorm_{j}",), cout)
            cin = cout
        cin += 3  # the next stage groups [centred xyz | these features]
    layer_norm = model == "pointnet_pp_mvm"
    for j, (cin, cout) in enumerate(_FC_WIDTHS):
        dense(top + (f"Dense_{j}",), cin, cout)
        norm(top + (f"{'LayerNorm' if layer_norm else 'BatchNorm'}_{j}",), cout,
             running_stats=not layer_norm)
    if model == "pointnet_pp_cls":
        dense(("Dense_2",), 256, num_classes)
    elif model == "pointnet_pp_mvm":
        for name, width in zip(_MVM_HEADS, (max_K, 2 * max_K, max_K)):
            dense((name,), 256, width)
        if mu_init == "spread":
            params["head_mu"]["bias"] = mu_bias_init(max_K, mu_init)
    elif model in _AXES_HEADS:
        for name in _AXES_HEADS[model]:
            dense((name,), 256, 3)
    else:
        width = {"pointnet_pp_8dir": 8, "pointnet_pp_fwd": 3, "pointnet_pp": 3,
                 "pointnet_pp_von_mises": 3 if mu_parameterization == "atan2" else 2}[model]
        dense(("Dense_0",), 256, width)
    return {"params": params, "batch_stats": stats}
