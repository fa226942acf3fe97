"""Carry the JAX package's flax variables into the port, and make such a
variable tree with numpy alone, for the 8-dir model (``PointNetPP8Dir``)
and the classifier (``PointNetPPCls``).

A tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
arrays (or anything ``np.asarray`` takes) under flax's names. A flax Dense
``kernel`` is ``(Cin, Cout)``, the transpose of ``nn.Linear.weight``;
BatchNorm has ``scale``/``bias`` params and ``mean``/``var`` statistics.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch

from ..models.pointnet_pp import PointNetPP8Dir, PointNetPPCls

Model = Union[PointNetPP8Dir, PointNetPPCls]

# MLP widths of each set abstraction (the grouped input width is 3 plus the
# previous stage's output, or plus the cloud's features for the first)
_SA_WIDTHS = ((64, 64, 128), (128, 128, 256), (256, 512, 1024))
_FC_WIDTHS = ((1024, 512), (512, 256))
# the classifier's set-abstraction scopes sit at the top of its tree, the
# 8-dir model's under its trunk
_SCOPE = {"pointnet_pp_8dir": ("PointNetPPTrunk_0",), "pointnet_pp_cls": ()}


def _pairs(model: Model) -> Iterator[Tuple]:
    """(Dense scope, Linear, BatchNorm scope, BatchNorm) for every layer of
    the model, the last two None for the output layer."""
    if isinstance(model, PointNetPPCls):
        top, sas = (), (model.sa1, model.sa2, model.sa3)
        fcs = ((model.fc1, model.bn1), (model.fc2, model.bn2), (model.fc3, None))
    else:
        trunk = model.trunk
        top, sas = ("PointNetPPTrunk_0",), (trunk.sa1, trunk.sa2, trunk.sa3)
        fcs = ((trunk.fc1, trunk.bn1), (trunk.fc2, trunk.bn2))
    for i, sa in enumerate(sas):
        for j, (lin, bn) in enumerate(zip(sa.mlp.linears, sa.mlp.bns)):
            scope = top + (f"SetAbstraction_{i}", "SharedMLP_0")
            yield scope + (f"Dense_{j}",), lin, scope + (f"BatchNorm_{j}",), bn
    for j, (lin, bn) in enumerate(fcs):
        yield top + (f"Dense_{j}",), lin, (None if bn is None else top + (f"BatchNorm_{j}",)), bn
    if isinstance(model, PointNetPP8Dir):
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


def load_flax_variables(model: Model, variables: Dict) -> Model:
    """Copy a flax ``{"params", "batch_stats"}`` tree of the JAX package's
    ``PointNetPP8Dir`` or ``PointNetPPCls`` into the port's ``model`` of the
    same kind in place; returns the model. Raises on a missing entry or a
    shape that does not match (for the classifier, build the model with
    :func:`cls_kwargs` of the tree)."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    for lin_path, lin, bn_path, bn in _pairs(model):
        dense = _get(params, lin_path, "params")
        name = "/".join(lin_path)
        _copy(lin.weight, np.asarray(dense["kernel"]).T, name + "/kernel")
        _copy(lin.bias, dense["bias"], name + "/bias")
        if bn is None:
            continue
        if stats is None:
            raise KeyError("variables has no batch_stats; the model's BatchNorm needs them")
        p = _get(params, bn_path, "params")
        st = _get(stats, bn_path, "batch_stats")
        name = "/".join(bn_path)
        _copy(bn.weight, p["scale"], name + "/scale")
        _copy(bn.bias, p["bias"], name + "/bias")
        _copy(bn.running_mean, st["mean"], name + "/mean")
        _copy(bn.running_var, st["var"], name + "/var")
    return model


def _set(tree: Dict, path: Tuple[str, ...], value: Dict) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _np(t: torch.Tensor, name: str) -> np.ndarray:
    if t is None:
        raise ValueError(f"{name} has no gradient")
    return t.detach().cpu().numpy().copy()


def to_flax_variables(model: Model, grads: bool = False) -> Dict:
    """The model's weights and running statistics as a flax
    ``{"params", "batch_stats"}`` tree of numpy arrays in the JAX package's
    layout (the inverse of :func:`load_flax_variables`). With ``grads=True``,
    ``{"params": ...}`` holds the parameters' ``.grad`` instead, so that a
    step's gradients compare leaf by leaf with ``jax.grad``'s."""
    params: Dict = {}
    stats: Dict = {}

    def value(p: torch.Tensor, name: str) -> np.ndarray:
        return _np(p.grad if grads else p, name)

    for lin_path, lin, bn_path, bn in _pairs(model):
        name = "/".join(lin_path)
        _set(params, lin_path, {"kernel": value(lin.weight, name + "/kernel").T.copy(),
                                "bias": value(lin.bias, name + "/bias")})
        if bn is None:
            continue
        name = "/".join(bn_path)
        _set(params, bn_path, {"scale": value(bn.weight, name + "/scale"),
                               "bias": value(bn.bias, name + "/bias")})
        _set(stats, bn_path, {"mean": _np(bn.running_mean, name + "/mean"),
                              "var": _np(bn.running_var, name + "/var")})
    return {"params": params} if grads else {"params": params, "batch_stats": stats}


def random_flax_variables(seed: int, model: str = "pointnet_pp_8dir", in_channels: int = 3,
                          num_classes: int = 40) -> Dict:
    """A variable tree of the JAX package's ``model`` (``pointnet_pp_8dir``,
    or ``pointnet_pp_cls`` with ``in_channels`` 3 or 6 and ``num_classes``)
    in its layout, made with numpy from ``seed``: LeCun-normal kernels,
    small random biases, and BatchNorm with random scale, shift, mean and
    variance (var in [0.5, 1.5]), so that folding BatchNorm into the kernels
    is exercised."""
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

    def batchnorm(path, c):
        _set(params, path, {
            "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
        })
        _set(stats, path, {
            "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
        })

    cin = in_channels if model == "pointnet_pp_cls" else 3
    for i, widths in enumerate(_SA_WIDTHS):
        scope = top + (f"SetAbstraction_{i}", "SharedMLP_0")
        for j, cout in enumerate(widths):
            dense(scope + (f"Dense_{j}",), cin, cout)
            batchnorm(scope + (f"BatchNorm_{j}",), cout)
            cin = cout
        cin += 3  # the next stage groups [centred xyz | these features]
    for j, (cin, cout) in enumerate(_FC_WIDTHS):
        dense(top + (f"Dense_{j}",), cin, cout)
        batchnorm(top + (f"BatchNorm_{j}",), cout)
    if model == "pointnet_pp_cls":
        dense(("Dense_2",), 256, num_classes)
    else:
        dense(("Dense_0",), 256, 8)
    return {"params": params, "batch_stats": stats}
