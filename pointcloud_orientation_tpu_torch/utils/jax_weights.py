"""Carry the JAX package's flax variables into the port, and make such a
variable tree with numpy alone.

A tree is ``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
arrays (or anything ``np.asarray`` takes) under flax's names. A flax Dense
``kernel`` is ``(Cin, Cout)``, the transpose of ``nn.Linear.weight``;
BatchNorm has ``scale``/``bias`` params and ``mean``/``var`` statistics.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..models.layers import PointNetPPTrunk, SharedMLP
from ..models.pointnet_pp import PointNetPP8Dir

# (input width, MLP widths) of each set abstraction, and the FC funnel
_SA_WIDTHS = ((3, (64, 64, 128)), (3 + 128, (128, 128, 256)), (3 + 256, (256, 512, 1024)))
_FC_WIDTHS = ((1024, 512), (512, 256))
_HEAD_WIDTHS = (256, 8)


def _pairs(model: PointNetPP8Dir) -> Iterator[Tuple]:
    """(Dense scope, Linear, BatchNorm scope, BatchNorm) for every layer of
    the model, the last two None for the head."""
    trunk: PointNetPPTrunk = model.trunk
    for i, sa in enumerate((trunk.sa1, trunk.sa2, trunk.sa3)):
        mlp: SharedMLP = sa.mlp
        for j, (lin, bn) in enumerate(zip(mlp.linears, mlp.bns)):
            scope = ("PointNetPPTrunk_0", f"SetAbstraction_{i}", "SharedMLP_0")
            yield scope + (f"Dense_{j}",), lin, scope + (f"BatchNorm_{j}",), bn
    for j, (lin, bn) in enumerate(((trunk.fc1, trunk.bn1), (trunk.fc2, trunk.bn2))):
        yield ("PointNetPPTrunk_0", f"Dense_{j}"), lin, ("PointNetPPTrunk_0", f"BatchNorm_{j}"), bn
    yield ("Dense_0",), model.head, None, None


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


def load_flax_variables(model: PointNetPP8Dir, variables: Dict) -> PointNetPP8Dir:
    """Copy a flax ``{"params", "batch_stats"}`` tree of the JAX package's
    ``PointNetPP8Dir`` into ``model`` in place; returns the model. Raises on
    a missing entry or a shape that does not match."""
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


def to_flax_variables(model: PointNetPP8Dir, grads: bool = False) -> Dict:
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


def random_flax_variables(seed: int) -> Dict:
    """A ``PointNetPP8Dir`` variable tree in the JAX package's layout, made
    with numpy from ``seed``: LeCun-normal kernels, small random biases, and
    BatchNorm with random scale, shift, mean and variance (var in
    [0.5, 1.5]), so that folding BatchNorm into the kernels is exercised."""
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

    for i, (cin, widths) in enumerate(_SA_WIDTHS):
        scope = ("PointNetPPTrunk_0", f"SetAbstraction_{i}", "SharedMLP_0")
        for j, cout in enumerate(widths):
            dense(scope + (f"Dense_{j}",), cin, cout)
            batchnorm(scope + (f"BatchNorm_{j}",), cout)
            cin = cout
    for j, (cin, cout) in enumerate(_FC_WIDTHS):
        dense(("PointNetPPTrunk_0", f"Dense_{j}"), cin, cout)
        batchnorm(("PointNetPPTrunk_0", f"BatchNorm_{j}"), cout)
    dense(("Dense_0",), *_HEAD_WIDTHS)
    return {"params": params, "batch_stats": stats}
