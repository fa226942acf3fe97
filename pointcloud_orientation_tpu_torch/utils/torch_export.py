"""Write the port's weights as the reference's PyTorch checkpoints.

Counterpart of ``pointcloud_orientation_tpu/utils/torch_export.py``, the
inverse of :mod:`.torch_import`: a flax-layout ``(params, batch_stats)``
tree (:func:`.jax_weights.to_flax_variables` of a port module, or the JAX
package's own) becomes a ``state_dict`` under the reference's names that its
model classes load with ``load_state_dict(..., strict=True)``. A Dense
kernel ``(Cin, Cout)`` becomes a ``Conv2d`` weight ``(Cout, Cin, 1, 1)`` in
the set abstractions and a ``Linear`` weight ``(out, in)`` elsewhere;
BatchNorm gets ``weight``/``bias``/``running_mean``/``running_var`` and a
zero ``num_batches_tracked``; the PointNet backbones' pointwise layers are
``Conv1d`` weights ``(Cout, Cin, 1)``.

As the JAX module, it is also a CLI from an Orbax checkpoint (the JAX
package's ``Trainer.save_checkpoint``, read without orbax by
:func:`.orbax_format.read_pytree`) to a reference-loadable ``.pth``::

    python -m pointcloud_orientation_tpu_torch.utils.torch_export \\
        --orbax results/run/ckpt/step_100 --model pointnet_pp_8dir --out best.pth
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .torch_import import (
    ENCODER_MAP,
    HEADS,
    PN_HEAD_MAP,
    POINTNET,
    SIMPLE_MAP,
    STN_MAP,
    STNS,
    TRANSFORMER,
)

_TRUNK = "PointNetPPTrunk_0"


def _np(a) -> np.ndarray:
    return np.asarray(a)


def _batch_norm(out: Dict, name: str, p: Mapping, st: Mapping) -> None:
    n = _np(p["scale"]).shape[0]
    out[f"{name}.weight"] = _np(p["scale"])
    out[f"{name}.bias"] = _np(p["bias"])
    out[f"{name}.running_mean"] = _np(st.get("mean", np.zeros(n, np.float32)))
    out[f"{name}.running_var"] = _np(st.get("var", np.ones(n, np.float32)))
    out[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)


def export_pointnet_pp_state_dict(params: Mapping[str, Any],
                                  batch_stats: Optional[Mapping[str, Any]] = None,
                                  model: str = "pointnet_pp_8dir") -> Dict[str, np.ndarray]:
    """A PointNet++-family flax tree as the reference's ``state_dict``
    (numpy values; a missing running statistic is written as mean 0, var
    1)."""
    if model not in HEADS:
        raise ValueError(f"unsupported model for export: {model}")
    out: Dict[str, np.ndarray] = {}
    trunk_p = params[_TRUNK]
    trunk_s = (batch_stats or {}).get(_TRUNK, {})
    for k in range(3):
        sa_p = trunk_p[f"SetAbstraction_{k}"]["SharedMLP_0"]
        sa_s = trunk_s.get(f"SetAbstraction_{k}", {}).get("SharedMLP_0", {})
        i = 0
        while f"Dense_{i}" in sa_p:
            d = sa_p[f"Dense_{i}"]
            out[f"sa{k + 1}.convs.{i}.weight"] = _np(d["kernel"]).T[:, :, None, None]
            out[f"sa{k + 1}.convs.{i}.bias"] = _np(d["bias"])
            _batch_norm(out, f"sa{k + 1}.bns.{i}", sa_p[f"BatchNorm_{i}"],
                        sa_s.get(f"BatchNorm_{i}", {}))
            i += 1
    for idx, name in ((0, "fc1"), (1, "fc2")):
        d = trunk_p[f"Dense_{idx}"]
        out[f"{name}.weight"] = _np(d["kernel"]).T
        out[f"{name}.bias"] = _np(d["bias"])
    for idx in (0, 1):
        if model == "pointnet_pp_mvm":
            ln = trunk_p[f"LayerNorm_{idx}"]
            out[f"ln{idx + 1}.weight"] = _np(ln["scale"])
            out[f"ln{idx + 1}.bias"] = _np(ln["bias"])
        else:
            _batch_norm(out, f"bn{idx + 1}", trunk_p[f"BatchNorm_{idx}"],
                        trunk_s.get(f"BatchNorm_{idx}", {}))
    for torch_name, flax_name in HEADS[model].items():
        d = params[flax_name]
        out[f"{torch_name}.weight"] = _np(d["kernel"]).T
        out[f"{torch_name}.bias"] = _np(d["bias"])
    return out


def _emit_block(out: Dict, p_node: Mapping, s_node: Mapping, torch_name: str, kind: str,
                idx: int) -> None:
    """One reference layer from ``Dense_{idx}`` (``"conv"``: a ``Conv1d``
    weight ``(out, in, 1)``; ``"fc"``: a ``Linear`` weight) or
    ``BatchNorm_{idx}`` (``"bn"``) of a flax node."""
    if kind == "bn":
        _batch_norm(out, torch_name, p_node[f"BatchNorm_{idx}"],
                    (s_node or {}).get(f"BatchNorm_{idx}", {}))
        return
    d = p_node[f"Dense_{idx}"]
    w = _np(d["kernel"]).T
    out[f"{torch_name}.weight"] = w[:, :, None] if kind == "conv" else w
    out[f"{torch_name}.bias"] = _np(d["bias"])


def export_pointnet_state_dict(params: Mapping[str, Any],
                               batch_stats: Optional[Mapping[str, Any]] = None,
                               model: str = "pointnet") -> Dict[str, np.ndarray]:
    """A PointNet-family flax tree as the reference's ``state_dict``
    (``"pointnet"``, ``"pointnet_cls"``, ``"simple_pointnet"``; the inverse
    of ``torch_import.import_pointnet_state_dict``); a missing running
    statistic is written as mean 0, var 1, and an encoder without
    ``STNkd_0`` writes no ``fstn``."""
    if model not in POINTNET:
        raise ValueError(f"unsupported model for export: {model}")
    stats = batch_stats or {}
    out: Dict[str, np.ndarray] = {}
    if model == "simple_pointnet":
        for tname, (kind, idx) in SIMPLE_MAP.items():
            _emit_block(out, params, stats, tname, kind, idx)
        return out
    enc_attr = POINTNET[model]
    enc_p = params["PointNetEncoder_0"]
    enc_s = stats.get("PointNetEncoder_0", {})
    for tname, (kind, idx) in ENCODER_MAP.items():
        _emit_block(out, enc_p, enc_s, f"{enc_attr}.{tname}", kind, idx)
    for stn_attr, stn_mod in STNS.items():
        if stn_mod not in enc_p:
            continue
        for tname, (kind, idx) in STN_MAP.items():
            _emit_block(out, enc_p[stn_mod], enc_s.get(stn_mod, {}),
                        f"{enc_attr}.{stn_attr}.{tname}", kind, idx)
    for tname, (kind, idx) in PN_HEAD_MAP.items():
        _emit_block(out, params, stats, tname, kind, idx)
    return out


def export_point_transformer_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The ``point_transformer`` flax tree as the reference
    ``nn.TransformerEncoder`` model's ``state_dict`` (q, k, v stacked as the
    row thirds of ``in_proj_weight``)."""
    out: Dict[str, np.ndarray] = {}

    def dense(torch_name, node):
        out[f"{torch_name}.weight"] = _np(node["kernel"]).T
        out[f"{torch_name}.bias"] = _np(node["bias"])

    dense("input_proj", params["Dense_0"])
    dense("fc_out", params["Dense_1"])
    i = 0
    while f"TransformerEncoderLayer_{i}" in params:
        lp = params[f"TransformerEncoderLayer_{i}"]
        p = f"transformer.layers.{i}."
        attn = lp["MultiHeadDotProductAttention_0"]
        qkv_w, qkv_b = [], []
        for name in ("query", "key", "value"):
            k = _np(attn[name]["kernel"])  # (E, H, Dh)
            width = k.shape[0]
            qkv_w.append(k.reshape(width, width).T)
            qkv_b.append(_np(attn[name]["bias"]).reshape(width))
        out[p + "self_attn.in_proj_weight"] = np.concatenate(qkv_w, axis=0)
        out[p + "self_attn.in_proj_bias"] = np.concatenate(qkv_b, axis=0)
        ok = _np(attn["out"]["kernel"])  # (H, Dh, E)
        width = ok.shape[-1]
        out[p + "self_attn.out_proj.weight"] = ok.reshape(width, width).T
        out[p + "self_attn.out_proj.bias"] = _np(attn["out"]["bias"])
        dense(p + "linear1", lp["Dense_0"])
        dense(p + "linear2", lp["Dense_1"])
        for t, flax_name in (("norm1", "LayerNorm_0"), ("norm2", "LayerNorm_1")):
            out[p + t + ".weight"] = _np(lp[flax_name]["scale"])
            out[p + t + ".bias"] = _np(lp[flax_name]["bias"])
        i += 1
    return out


def export_state_dict(params: Mapping[str, Any], batch_stats: Optional[Mapping[str, Any]] = None,
                      model: str = "pointnet_pp_8dir") -> Dict[str, np.ndarray]:
    """Any supported model's flax tree as the reference's ``state_dict``;
    for a port module: ``export_state_dict(**to_flax_variables(module),
    model=...)``. The JAX package's ``ValueError`` for another model (the
    MoE transformer has no reference layout)."""
    if model in HEADS:
        return export_pointnet_pp_state_dict(params, batch_stats, model)
    if model == TRANSFORMER:
        return export_point_transformer_state_dict(params)
    if model in POINTNET:
        return export_pointnet_state_dict(params, batch_stats, model)
    raise ValueError(f"unsupported model for export: {model}")


def to_torch_state_dict(np_state_dict: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Wrap a numpy ``state_dict`` in CPU tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in np_state_dict.items()}


def save_torch_checkpoint(path: str, params: Mapping[str, Any],
                          batch_stats: Optional[Mapping[str, Any]] = None,
                          model: str = "pointnet_pp_8dir") -> None:
    """Write a reference-loadable ``.pth``: the raw ``state_dict``, as the
    reference saves its own. For a port module:
    ``save_torch_checkpoint(path, **to_flax_variables(module), model=...)``."""
    torch.save(to_torch_state_dict(export_state_dict(params, batch_stats, model)), path)


def main(argv=None) -> None:
    """CLI: an Orbax checkpoint (a ``step_<N>`` directory) to a
    reference-loadable ``.pth``, with the JAX CLI's flags."""
    import argparse
    import os

    from .orbax_format import read_pytree

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--orbax", required=True, help="Orbax checkpoint dir (a step_N directory)")
    ap.add_argument("--model", required=True,
                    choices=sorted(HEADS) + ["pointnet", "pointnet_cls", "simple_pointnet"])
    ap.add_argument("--out", required=True, help="output .pth path")
    args = ap.parse_args(argv)
    ckpt = read_pytree(os.path.abspath(args.orbax))
    save_torch_checkpoint(args.out, ckpt["params"], ckpt.get("batch_stats"), args.model)
    print(f"wrote {args.out} ({args.model})")


if __name__ == "__main__":
    main()
