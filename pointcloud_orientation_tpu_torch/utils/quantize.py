"""Weight-only int8 quantization for serving, on nested dicts.

Counterpart of ``pointcloud_orientation_tpu/utils/quantize.py``: every
weight matrix stored as int8 plus a per-output-channel f32 scale
(symmetric, no zero point), dequantized at use on the device
(:class:`..infer.OrientationPredictor`, ``quantize="int8"``). Activations,
accumulation and every operation stay f32. The quantized leaves are the
``kernel`` arrays of rank 2 or more (Dense kernels, the attention's 3-d
kernels); biases, norm scales and statistics stay f32.

A tree is a nested dict of arrays under flax's names, as
:mod:`.jax_weights` reads it; a leaf's path is its keys joined by ``/``
(``PointNetPPTrunk_0/SetAbstraction_0/SharedMLP_0/Dense_0/kernel``), the
JAX package's key. The ``.npz`` artifact holds the quantized tree under
``q::<path>``, the scales under ``s::<path>`` and the f32 batch statistics
under ``b::<path>``, so that one written by either package loads in the
other.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_Q, _S, _B = "q::", "s::", "b::"


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` of every leaf, keys in sorted order (``jax.tree_util``'s
    order for dicts)."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def map_leaves(tree: Mapping, fn, prefix: str = "") -> Dict:
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = map_leaves(value, fn, path) if isinstance(value, Mapping) else fn(path, value)
    return out


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else np.ndim(leaf)


def _is_quantizable(path: str, leaf) -> bool:
    """A ``kernel`` leaf of rank 2 or more."""
    return path.rsplit("/", 1)[-1] == "kernel" and _ndim(leaf) >= 2


def quantize_params_int8(params: Mapping) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """``(quantized, scales)``: ``quantized`` mirrors ``params`` with each
    quantizable kernel as ``round(w / scale)`` clipped to [-127, 127] in
    int8, the scale ``absmax / 127`` over every axis but the last (1 where
    a channel is all zero), kept with its axes as ``scales[path]``; every
    other leaf passes through unchanged."""
    scales: Dict[str, np.ndarray] = {}

    def q(path, leaf):
        if not _is_quantizable(path, leaf):
            return leaf
        w = np.asarray(leaf, np.float32)
        absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        scales[path] = scale
        return np.clip(np.round(w / scale), -127, 127).astype(np.int8)

    return map_leaves(params, q), scales


def dequantize_params(quantized: Mapping, scales: Mapping[str, torch.Tensor]) -> Dict:
    """The f32 tree of tensors: each leaf with a scale as ``q.float() *
    scale`` on the leaf's device; the other leaves as they are."""

    def d(path, leaf):
        return leaf.float() * scales[path] if path in scales else leaf

    return map_leaves(quantized, d)


def param_bytes(tree: Mapping) -> int:
    """The bytes of every leaf of a tree of arrays or tensors."""
    return sum(leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf).nbytes for _, leaf in _leaves(tree))


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_quantized_checkpoint(path: str, params: Mapping,
                              batch_stats: Optional[Mapping] = None) -> None:
    """Quantize ``params`` and write the int8 serving artifact to ``path``
    (``.npz``); batch statistics stay f32."""
    quantized, scales = quantize_params_int8(params)
    arrays = {_Q + k: np.asarray(v) for k, v in _leaves(quantized)}
    arrays.update({_S + k: v for k, v in scales.items()})
    if batch_stats:
        arrays.update({_B + k: np.asarray(v) for k, v in _leaves(batch_stats)})
    np.savez(path, **arrays)


def load_quantized_checkpoint(path: str) -> Tuple[Dict, Dict[str, np.ndarray], Optional[Dict]]:
    """``(quantized, scales, batch_stats)`` of an int8 artifact, as
    :class:`..infer.OrientationPredictor` takes them (``scales=``;
    ``from_quantized_checkpoint``); ``batch_stats`` is None when the
    artifact has none."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    part = {p: {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}
            for p in (_Q, _S, _B)}
    return _unflatten(part[_Q]), part[_S], (_unflatten(part[_B]) if part[_B] else None)
