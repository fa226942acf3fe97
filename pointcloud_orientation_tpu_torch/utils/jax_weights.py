"""Carry the JAX package's flax variables into the port, and make such a
variable tree with numpy alone, for the PointNet++ models of the port: the
yaw heads (``PointNetPP8Dir``, ``PointNetPPFwd``, ``PointNetPPVonMises``,
``PointNetPPMvM``), the SO(3) heads (``PointNetPP``, ``PointNetPPXYZ``,
``PointNetPPXYZSchmidt``) and the classifier (``PointNetPPCls``).

A tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
arrays (or anything ``np.asarray`` takes) under flax's names. A flax Dense
``kernel`` is ``(Cin, Cout)``, the transpose of ``nn.Linear.weight``;
BatchNorm has ``scale``/``bias`` params and ``mean``/``var`` statistics,
LayerNorm (the MvM trunk's funnel) ``scale``/``bias`` params only.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ..models.pointnet_pp import (
    PointNetPPCls,
    PointNetPPMvM,
    PointNetPPXYZ,
    PointNetPPXYZSchmidt,
    mu_bias_init,
)

# MLP widths of each set abstraction (the grouped input width is 3 plus the
# previous stage's output, or plus the cloud's features for the first)
_SA_WIDTHS = ((64, 64, 128), (128, 128, 256), (256, 512, 1024))
_FC_WIDTHS = ((1024, 512), (512, 256))
_TRUNK = ("PointNetPPTrunk_0",)
# the classifier's set-abstraction scopes sit at the top of its tree, the
# other models' under their trunk
_SCOPE = {"pointnet_pp_8dir": _TRUNK, "pointnet_pp_fwd": _TRUNK,
          "pointnet_pp_von_mises": _TRUNK, "pointnet_pp_mvm": _TRUNK, "pointnet_pp_cls": (),
          "pointnet_pp": _TRUNK, "pointnet_pp_xyz": _TRUNK, "pointnet_pp_xyz_schmidt": _TRUNK}
_MVM_HEADS = ("head_pi", "head_mu", "head_kappa")
# the two-axis heads' Dense scopes, each 3 wide
_AXES_HEADS = {"pointnet_pp_xyz": PointNetPPXYZ.HEADS,
               "pointnet_pp_xyz_schmidt": PointNetPPXYZSchmidt.HEADS}


def _pairs(model: nn.Module) -> Iterator[Tuple]:
    """(Dense scope, Linear, norm scope, norm module) for every layer of
    the model, the last two None for an output layer; the norm is a
    BatchNorm1d or, in the MvM trunk's funnel, a LayerNorm."""
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
            yield scope + (f"Dense_{j}",), lin, scope + (f"BatchNorm_{j}",), bn
    for j, (lin, norm) in enumerate(fcs):
        kind = "LayerNorm" if isinstance(norm, nn.LayerNorm) else "BatchNorm"
        yield top + (f"Dense_{j}",), lin, top + (f"{kind}_{j}",), norm
    if isinstance(model, PointNetPPCls):
        yield ("Dense_2",), model.fc3, None, None
    elif isinstance(model, (PointNetPPMvM, PointNetPPXYZ)):
        for name in _MVM_HEADS if isinstance(model, PointNetPPMvM) else model.HEADS:
            yield (name,), getattr(model, name), None, None
    else:
        yield ("Dense_0",), model.head, None, None


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
    for lin_path, lin, norm_path, norm in _pairs(model):
        dense = _get(params, lin_path, "params")
        name = "/".join(lin_path)
        _copy(lin.weight, np.asarray(dense["kernel"]).T, name + "/kernel")
        _copy(lin.bias, dense["bias"], name + "/bias")
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
    layout (the inverse of :func:`load_flax_variables`). With ``grads=True``,
    ``{"params": ...}`` holds the parameters' ``.grad`` instead, so that a
    step's gradients compare leaf by leaf with ``jax.grad``'s."""
    params: Dict = {}
    stats: Dict = {}

    def value(p: torch.Tensor, name: str) -> np.ndarray:
        return _np(p.grad if grads else p, name)

    for lin_path, lin, norm_path, norm in _pairs(model):
        name = "/".join(lin_path)
        _set(params, lin_path, {"kernel": value(lin.weight, name + "/kernel").T.copy(),
                                "bias": value(lin.bias, name + "/bias")})
        if norm is None:
            continue
        name = "/".join(norm_path)
        _set(params, norm_path, {"scale": value(norm.weight, name + "/scale"),
                                 "bias": value(norm.bias, name + "/bias")})
        if not isinstance(norm, nn.LayerNorm):
            _set(stats, norm_path, {"mean": _np(norm.running_mean, name + "/mean"),
                                    "var": _np(norm.running_var, name + "/var")})
    return {"params": params} if grads else {"params": params, "batch_stats": stats}


def model_kwargs(model: str, params: Dict) -> Dict:
    """Constructor arguments of the port's ``model`` that its flax tree
    fixes: the classifier's :func:`cls_kwargs`, the vM head's
    ``mu_parameterization`` (the tanh head is 2 wide, the atan2 head 3), the
    MvM head's ``max_K``; none for the others (the two-axis heads'
    ``gram_schmidt`` and ``normalize_heads`` are not in the tree)."""
    if model == "pointnet_pp_cls":
        return cls_kwargs(params)
    if model == "pointnet_pp_von_mises":
        width = np.shape(_get(params, ("Dense_0",), "params")["kernel"])[1]
        return {"mu_parameterization": "atan2" if width == 3 else "tanh"}
    if model == "pointnet_pp_mvm":
        return {"max_K": int(np.shape(_get(params, ("head_pi",), "params")["kernel"])[1])}
    return {}


def random_flax_variables(seed: int, model: str = "pointnet_pp_8dir", in_channels: int = 3,
                          num_classes: int = 40, mu_parameterization: str = "tanh",
                          max_K: int = 4, mu_init: str = "zero") -> Dict:
    """A variable tree of the JAX package's ``model`` in its layout, made
    with numpy from ``seed``: LeCun-normal kernels, small random biases,
    BatchNorm with random scale, shift, mean and variance (var in [0.5,
    1.5]), so that folding BatchNorm into the kernels is exercised, and
    LayerNorm with random scale and shift. ``pointnet_pp_cls`` takes
    ``in_channels`` 3 or 6 and ``num_classes``; ``pointnet_pp_von_mises``
    its ``mu_parameterization`` (a head 2 or 3 wide); ``pointnet_pp_mvm``
    ``max_K`` and ``mu_init`` (``"spread"``: ``head_mu``'s bias is the
    spread initialisation, the unit vectors at ``2 pi k / max_K``)."""
    if model not in _SCOPE:
        raise NotImplementedError(f"model {model!r}: the port has {sorted(_SCOPE)}")
    top = _SCOPE[model]
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
