"""Weights made from the seed on the device, in the benchmark's own layout,
and their exchange with the flax-layout trees that the port's predictor and
``load_flax_variables`` take.

The layout names each shared-MLP layer ``sa<i>.<j>``, each FC layer
``fc<j>`` and the output layer ``head``; a layer has ``w (in, out)`` and
``b``, a normalised one also ``gamma``, ``beta``, ``mean`` and ``var``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def layer_shapes(config: Dict) -> List[Tuple[str, int, int, bool]]:
    """``(name, in, out, normalised)`` of every layer, input to output."""
    m = config["model"]
    out, feat = [], 0
    for i, st in enumerate(m["sa"]):
        widths = [3 + feat, *st["mlp"]]
        out += [(f"sa{i}.{j}", a, b, True) for j, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]
        feat = st["mlp"][-1]
    widths = [feat, *m["fc"]]
    out += [(f"fc{j}", a, b, True) for j, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]
    out.append(("head", widths[-1], m["classes_out"], False))
    return out


def make_weights(config: Dict, seed: int, device: torch.device, serving: bool
                 ) -> Dict[str, torch.Tensor]:
    """Every weight from one normal and one uniform draw of a generator on
    ``device`` seeded with ``seed``. Kernels are LeCun normal (variance
    1/fan_in). For training the rest is flax's initialisation: zero biases,
    BatchNorm scale 1, shift 0, mean 0, variance 1. For serving the biases,
    scales, shifts and statistics are drawn too (scale 1 + N(0, 0.1^2),
    the others N(0, 0.1^2), variance in [0.5, 1.5]), so that folding
    BatchNorm into the kernels is exercised."""
    shapes = layer_shapes(config)
    n_normal = sum(a * b + 4 * b for _, a, b, _ in shapes)
    n_uniform = sum(b for _, _, b, norm in shapes if norm)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    z = torch.randn(n_normal, generator=g, device=device)
    u = torch.rand(n_uniform, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    zi = ui = 0
    for name, a, b, norm in shapes:
        out[f"{name}.w"] = z[zi: zi + a * b].view(a, b) / math.sqrt(a)
        zi += a * b
        extra = z[zi: zi + 4 * b].view(4, b) * 0.1
        zi += 4 * b
        out[f"{name}.b"] = extra[0] if serving else torch.zeros(b, device=device)
        if not norm:
            continue
        if serving:
            out[f"{name}.gamma"], out[f"{name}.beta"] = 1.0 + extra[1], extra[2]
            out[f"{name}.mean"], out[f"{name}.var"] = extra[3], 0.5 + u[ui: ui + b]
        else:
            out[f"{name}.gamma"] = torch.ones(b, device=device)
            out[f"{name}.beta"] = torch.zeros(b, device=device)
            out[f"{name}.mean"] = torch.zeros(b, device=device)
            out[f"{name}.var"] = torch.ones(b, device=device)
        ui += b
    return {k: v.contiguous() for k, v in out.items()}


def _flax_paths(config: Dict) -> Dict[str, Tuple[Tuple[str, ...], Tuple[str, ...]]]:
    """Each layer's flax paths: ``(Dense path, BatchNorm path or ())``."""
    lay = config["model"]["flax"]
    trunk = (lay["trunk"],) if lay["trunk"] else ()
    paths = {}
    for name, _, _, norm in layer_shapes(config):
        if name.startswith("sa"):
            i, j = name[2:].split(".")
            base = trunk + (f"SetAbstraction_{i}", "SharedMLP_0")
            paths[name] = (base + (f"Dense_{j}",), base + (f"BatchNorm_{j}",))
        elif name.startswith("fc"):
            j = name[2:]
            paths[name] = (trunk + (f"Dense_{j}",), trunk + (f"BatchNorm_{j}",))
        else:
            paths[name] = ((lay["head"],), ())
    return paths


def _set(tree: Dict, path: Tuple[str, ...], key: str, value: np.ndarray) -> None:
    for p in path:
        tree = tree.setdefault(p, {})
    tree[key] = value


def _get(tree: Dict, path: Tuple[str, ...], key: str) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree[key])


def to_flax(config: Dict, weights: Dict[str, torch.Tensor]) -> Dict:
    """The weights as a flax ``{"params", "batch_stats"}`` tree of numpy
    arrays, copied to the host in one transfer."""
    names = sorted(weights)
    flat = torch.cat([weights[k].reshape(-1).float() for k in names]).cpu().numpy()
    host, off = {}, 0
    for k in names:
        n = weights[k].numel()
        host[k] = flat[off: off + n].reshape(tuple(weights[k].shape))
        off += n
    tree: Dict = {"params": {}, "batch_stats": {}}
    for name, (dense, bn) in _flax_paths(config).items():
        _set(tree["params"], dense, "kernel", host[f"{name}.w"])
        _set(tree["params"], dense, "bias", host[f"{name}.b"])
        if bn:
            _set(tree["params"], bn, "scale", host[f"{name}.gamma"])
            _set(tree["params"], bn, "bias", host[f"{name}.beta"])
            _set(tree["batch_stats"], bn, "mean", host[f"{name}.mean"])
            _set(tree["batch_stats"], bn, "var", host[f"{name}.var"])
    return tree


def from_flax(config: Dict, tree: Dict, device: torch.device, stats: bool = True
              ) -> Dict[str, torch.Tensor]:
    """A flax tree (``params`` and, with ``stats``, ``batch_stats``) in the
    benchmark's layout on ``device``."""
    out = {}
    for name, (dense, bn) in _flax_paths(config).items():
        vals = {"w": _get(tree["params"], dense, "kernel"), "b": _get(tree["params"], dense, "bias")}
        if bn:
            vals["gamma"] = _get(tree["params"], bn, "scale")
            vals["beta"] = _get(tree["params"], bn, "bias")
            if stats:
                vals["mean"] = _get(tree["batch_stats"], bn, "mean")
                vals["var"] = _get(tree["batch_stats"], bn, "var")
        for k, v in vals.items():
            out[f"{name}.{k}"] = torch.from_numpy(np.array(v, np.float32)).to(device)
    return out


def is_param(key: str) -> bool:
    """Whether a layout key is a trained parameter (not a running
    statistic)."""
    return key.rsplit(".", 1)[1] not in ("mean", "var")
