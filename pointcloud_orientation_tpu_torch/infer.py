"""Batched serving of the port's models on the card.

Counterpart of ``pointcloud_orientation_tpu/infer.py`` ``OrientationPredictor``
for the models ``pointnet_pp_8dir`` (8-way direction logits),
``pointnet_pp_fwd`` (unit forward vectors), ``pointnet_pp_von_mises`` ((mu,
kappa)), ``pointnet_pp_mvm`` ((mu, kappa, weight)), ``pointnet_pp`` (raw
forward vectors), ``pointnet_pp_xyz`` ((x, y) axes),
``pointnet_pp_xyz_schmidt`` ((up, forward)), ``pointnet_pp_cls``
(ModelNet40 log-probabilities), ``point_transformer`` (raw forward vectors;
``attention_impl="flash"`` through the flash kernels), ``simple_pointnet``
and ``pointnet`` (raw forward vectors) and ``pointnet_cls``
((log-probabilities, feature transform)) in eval mode, on one device; f32,
or bf16 (``dtype="bfloat16"``, the JAX package's ``**model_kwargs``).
Requests are padded to power-of-two batch buckets (clamped to
``max_batch``) and to ``num_points`` points, exactly as the JAX predictor
pads them. ``tta_views`` votes over yaw-rotated views of each request and
``quantize="int8"`` serves int8 weights dequantized on the device, as there;
``ensemble_size`` serves a deep ensemble of S members (stacked flax trees,
:meth:`OrientationPredictor.from_seed_sweep`,
:meth:`OrientationPredictor.from_protocol_checkpoint`). ``mesh=`` serves
data-parallel over the mesh's ``mesh_axis``: weights replicated, each
rank running its slice of the bucket, the outputs gathered so that every
rank returns the whole request.

Example
-------
    from pointcloud_orientation_tpu_torch.infer import OrientationPredictor
    from pointcloud_orientation_tpu_torch.utils import random_flax_variables

    v = random_flax_variables(0)
    predictor = OrientationPredictor("pointnet_pp_8dir", v["params"], v["batch_stats"])
    logits = predictor(clouds)              # (B, N, 3) numpy -> (B, 8)
    fwd = predictor.forward_vectors(clouds)  # unit forward vectors (B, 3)
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .models import MODEL_REGISTRY, MULTI_OUTPUT_MODELS
from .ops import DIRS_8
from .models.layers import compute_dtype
from .ops.batch_shard import batch_shard
from .ops.cuda_kernels import bf16_matmuls, f32_matmuls
from .ops.rotations import wrap_angle, yaw_matrix
from .ops.von_mises import vm_mixture_moment_match
from .utils.jax_weights import kernel_parameters, load_flax_variables
from .utils.jax_weights import model_kwargs as tree_kwargs
from .parallel.comm import all_gather_cat
from .parallel.mesh import batch_sharding, replicate
from .utils.quantize import dequantize_params, map_leaves, quantize_params_int8

Output = Union[np.ndarray, Tuple[np.ndarray, ...]]

# the yaw-equivariant head families, by how views combine
TTA_VECTOR = ("pointnet_pp", "pointnet_pp_fwd", "simple_pointnet", "point_transformer")
TTA_TUPLE = ("pointnet_pp_xyz", "pointnet_pp_xyz_schmidt")
TTA_DIST = ("pointnet_pp_von_mises", "pointnet_pp_mvm")


def tta_mode(model_name: str) -> str:
    """How ``model_name``'s views combine: ``"slots"`` (8-dir), ``"tuple"``
    (the two-axis heads), ``"vm"``, ``"mvm"`` or ``"vector"``."""
    if model_name == "pointnet_pp_8dir":
        return "slots"
    if model_name in TTA_TUPLE:
        return "tuple"
    return {"pointnet_pp_von_mises": "vm", "pointnet_pp_mvm": "mvm"}.get(model_name, "vector")


def tta_angles(mode: str, views: int) -> torch.Tensor:
    """The views' yaw angles (f32): multiples of 45 degrees ``i * (8 /
    views) * pi / 4`` for 8-dir, else ``i * 2 pi / views``."""
    if mode == "slots":
        step = 8 // views
        return torch.tensor([i * step * math.pi / 4 for i in range(views)], dtype=torch.float32)
    return torch.tensor([i * 2.0 * math.pi / views for i in range(views)], dtype=torch.float32)


def _apply3(rots: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """``rots (V, 1.., 3, 3)`` applied to ``vecs (.., 3)`` as ``(r_i0 v_0 +
    r_i1 v_1) + r_i2 v_2``, elementwise in f32, the same order on any
    device."""
    first = rots[..., 0] * vecs[..., 0:1] + rots[..., 1] * vecs[..., 1:2]
    return first + rots[..., 2] * vecs[..., 2:3]


def rotate_views(pts: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """``(B, N, 3)`` clouds under each of ``rots (V, 3, 3)``, stacked view
    by view: ``(V * B, N, 3)``."""
    return _apply3(rots[:, None, None], pts[None]).reshape(-1, *pts.shape[1:])


def derotate_mean(vecs: torch.Tensor, rots: torch.Tensor, members: int = 1) -> torch.Tensor:
    """The vectors ``(S * V * B, 3)`` of ``members`` S by ``V`` views,
    each rotated back by its view's ``R^T`` and averaged over members and
    views: ``(B, 3)``."""
    V = rots.shape[0]
    vv = vecs.reshape(members, V, -1, 3)
    return _apply3(rots.transpose(1, 2)[None, :, None], vv).mean(dim=(0, 1))


def tta_combine(mode: str, out, angles: torch.Tensor, rots: torch.Tensor, members: int = 1):
    """The JAX predictor's combine of a model output over ``members`` S by
    ``V`` views, stacked member-major, then view by view (``S * V * B``
    rows; ensemble members are views at angle 0): 8-dir ``log(mean over
    members and views of each view's softmax rolled back by its slots +
    1e-12)``; vector and two-axis heads the derotated mean; vM each mu
    shifted by its view's angle, then
    :func:`.ops.von_mises.vm_mixture_moment_match` over all S * V; MvM the
    exact mixture of ``S * V * K`` components (mu shifted and wrapped,
    weights divided by ``S * V``), the component axis ordered member-major,
    then view, then component, as the JAX package's ``moveaxis`` leaves
    it."""
    S, V = members, angles.shape[0]
    if mode == "slots":
        step = 8 // V
        probs = torch.softmax(out, dim=-1).reshape(S, V, -1, 8)
        unshifted = torch.stack([torch.roll(probs[:, i], i * step, dims=-1) for i in range(V)],
                                dim=1)
        return torch.log(unshifted.mean(dim=(0, 1)) + 1e-12)
    if mode == "vm":
        mu, kappa = out
        mu = mu.reshape(S, V, -1) + angles[None, :, None]
        return vm_mixture_moment_match(mu.reshape(S * V, -1), kappa.reshape(S * V, -1), dim=0)
    if mode == "mvm":
        mu, kappa, w = out
        K = mu.shape[-1]
        mu = wrap_angle(mu.reshape(S, V, -1, K) + angles[None, :, None, None])

        def member_view_major(t):
            return t.reshape(S * V, -1, K).transpose(0, 1).reshape(-1, S * V * K)

        return member_view_major(mu), member_view_major(kappa), member_view_major(w) / (S * V)
    if mode == "tuple":
        return tuple(derotate_mean(v, rots, S) for v in out)
    return derotate_mean(out, rots, S)


ENSEMBLE_MODELS = TTA_VECTOR + TTA_TUPLE + TTA_DIST + ("pointnet_pp_8dir",)


def _member(tree: Optional[Dict], i: int) -> Optional[Dict]:
    """Member ``i`` of a flax tree stacked on a leading member axis."""
    return None if tree is None else map_leaves(tree, lambda _, x: np.asarray(x)[i])


def _leaves(tree):
    """The leaves of a nested dict, depth first."""
    for value in tree.values():
        yield from (_leaves(value) if isinstance(value, dict) else (value,))


def _stack(trees) -> Dict:
    """Flax trees stacked leaf by leaf on a new leading member axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


class OrientationPredictor:
    """Bucketed predictor over one of the port's models (``MODEL_REGISTRY``).

    ``params``/``batch_stats`` are the JAX package's flax trees as numpy
    arrays (see :mod:`.utils.jax_weights`); what the tree fixes is read from
    it (the classifiers' input width and class count, the vM head's mu
    parameterisation, the MvM head's ``max_K``, PointNet's feature
    transform). Runs on ``device`` ("cuda" unless the caller asks for the
    CPU). Random centroids and FPS start points are drawn from a
    ``torch.Generator`` seeded with ``seed``; they match the JAX predictor's
    only in distribution (``sampling="first"`` makes the trunk heads
    deterministic). ``model_kwargs`` go to the model: ``dtype=torch.bfloat16``
    (or ``"bfloat16"``) serves a trunk in bf16; ``sampling`` and
    ``grouping`` of a trunk head, the MvM head's ``temp``, ``kappa_max`` and
    ``weight_floor``, the two-axis heads' ``normalize_heads`` and
    ``gram_schmidt``, the transformer's ``attention_impl`` (``"xla"`` or
    ``"flash"``; the flash kernels take ``num_points`` in multiples of
    128) and ``dtype``.

    ``tta_views``: yaw-voting test-time augmentation for the yaw-equivariant
    heads, one model call on the ``(V * bucket, N, 3)`` views built on the
    device (:func:`rotate_views`) and combined by :func:`tta_combine`:
    8-dir at V in (2, 4, 8), any V for the vector, two-axis, vM and MvM
    heads; the outputs keep each head's contract (the MvM head's component
    axis is ``V * max_K`` wide). ``quantize="int8"`` quantizes the Dense
    kernels (:func:`.utils.quantize.quantize_params_int8`); ``scales=``
    takes ``params`` already quantized with their scales (as
    :meth:`from_quantized_checkpoint` loads them). The int8 kernels and
    their scales stay on the device and each request dequantizes them
    there and runs the model through ``torch.func.functional_call``; the
    module keeps no f32 copy of them. ``ensemble_size`` S: a deep ensemble
    whose ``params``/``batch_stats`` carry a leading member axis of S (see
    :meth:`from_seed_sweep`); a request runs the S member modules one after
    another on the same (view-stacked) batch, each from the same generator
    state (the JAX predictor passes one ``rng`` to every member), and
    combines the S * V outputs by :func:`tta_combine`: S times a single
    request's launches. ``mesh``/``mesh_axis``: data-parallel serving
    over a :func:`.parallel.make_mesh` mesh (every rank builds the
    predictor and calls it with the same request): the weights are
    broadcast from the first rank, the bucket rounds up to a multiple of the
    axis size (the clamp too, as the JAX predictor's), each rank runs its
    rows with the random draws of the whole bucket
    (:mod:`.ops.batch_shard`) and the outputs are all-gathered. The JAX
    package's ``ValueError``s stand: a model that returns ``(out, aux)``
    (``MULTI_OUTPUT_MODELS``, the MoE transformer), ``tta_views < 1``, an
    8-dir V outside (2, 4, 8), TTA or an ensemble on a head with no
    combine, an ensemble with int8 weights, ``ensemble_size < 1``, an
    unknown ``quantize``, TTA or an ensemble with a mesh; and ``params``
    without the leading member axis.
    """

    def __init__(
        self,
        model_name: str,
        params: Dict,
        batch_stats: Optional[Dict] = None,
        num_points: int = 1024,
        max_batch: int = 256,
        seed: int = 0,
        quantize: Optional[str] = None,
        scales: Optional[Dict] = None,
        mesh=None,
        mesh_axis: str = "data",
        tta_views: int = 1,
        ensemble_size: int = 1,
        device: str | torch.device = "cuda",
        **model_kwargs: Any,
    ):
        if model_name in MULTI_OUTPUT_MODELS:
            raise ValueError(
                f"{model_name!r} returns (out, aux_loss) — a training-only "
                "contract (task 'forward_mse_aux'); the serving predictor "
                "requires a single-output head. Serve 'point_transformer' "
                "(the dense variant) instead.")
        if model_name not in MODEL_REGISTRY:
            raise NotImplementedError(
                f"model {model_name!r} is not ported; the port serves {sorted(MODEL_REGISTRY)}")
        if tta_views < 1:
            raise ValueError(f"tta_views must be >= 1, got {tta_views}")
        if ensemble_size < 1:
            raise ValueError(f"ensemble_size must be >= 1, got {ensemble_size}")
        if tta_views > 1:
            if model_name == "pointnet_pp_8dir":
                if tta_views not in (2, 4, 8):
                    raise ValueError("8-dir TTA needs 45°-multiple views: tta_views in "
                                     f"(2, 4, 8), got {tta_views}")
            elif model_name not in TTA_VECTOR + TTA_TUPLE + TTA_DIST:
                raise ValueError(
                    "yaw-voting TTA needs a yaw-equivariant head (8-dir slot shift, "
                    "forward/axes vector derotation, or vM/MvM angle derotation); model "
                    f"{model_name!r} is unsupported")
        if ensemble_size > 1:
            if model_name not in ENSEMBLE_MODELS:
                raise ValueError(
                    "ensemble combining needs a head family with a defined average (8-dir "
                    f"probs, vectors, vM/MvM densities); model {model_name!r} is unsupported")
            if quantize is not None or scales is not None:
                raise ValueError("ensemble_size > 1 with int8 quantization is unsupported "
                                 "(per-member scale trees don't stack)")
            lead = {np.shape(x)[0] if np.ndim(x) else None for x in _leaves(params)}
            if lead != {ensemble_size}:
                raise ValueError(f"ensemble_size={ensemble_size} needs params stacked on a "
                                 f"leading member axis of {ensemble_size}; leading sizes {lead}")
        if (tta_views > 1 or ensemble_size > 1) and mesh is not None:
            raise ValueError("tta_views/ensemble_size > 1 with a mesh is unsupported (the "
                             "view/member-stacked batch would break the bucket sharding)")
        if scales is None and quantize is not None:
            if quantize != "int8":
                raise ValueError(f"unknown quantize mode {quantize!r}")
            params, scales = quantize_params_int8(params)
        if num_points < 1 or max_batch < 1:
            raise ValueError(f"num_points={num_points} and max_batch={max_batch} must be >= 1")
        self.device = torch.device(device)
        self.model_name = model_name
        self.num_points = num_points
        self.max_batch = max_batch
        self.tta_views = tta_views
        self.ensemble_size = ensemble_size
        self._tta_mode = tta_mode(model_name)
        self._angles = tta_angles(self._tta_mode, tta_views).to(self.device)
        self._rots = yaw_matrix(self._angles)
        members = ([(_member(params, i), _member(batch_stats, i)) for i in range(ensemble_size)]
                   if ensemble_size > 1 else [(params, batch_stats)])
        params, batch_stats = members[0]
        model_kwargs = {**tree_kwargs(model_name, params), **model_kwargs}
        model = MODEL_REGISTRY[model_name](**model_kwargs)
        self.channels = getattr(model, "in_channels", 3)
        self._int8: Dict[str, Tuple[str, int]] = {}  # kernel path -> (weight name, in_features)
        self._quantized: Dict[str, torch.Tensor] = {}
        self._scales: Dict[str, torch.Tensor] = {}
        if scales is not None:
            params = self._hold_int8(model, params, scales)
        load_flax_variables(model, {"params": params, "batch_stats": batch_stats})
        for name, _ in self._int8.values():  # no f32 copy of an int8 kernel
            owner, leaf = model.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
            setattr(owner, leaf, nn.Parameter(torch.empty(0), requires_grad=False))
        self.model = model.to(self.device).eval()
        self.members = [self.model]  # the ensemble's modules, member 0 first
        for p, bs in members[1:]:
            other = MODEL_REGISTRY[model_name](**model_kwargs)
            load_flax_variables(other, {"params": p, "batch_stats": bs})
            self.members.append(other.to(self.device).eval())
        self.sharding = None if mesh is None else batch_sharding(mesh, mesh_axis)
        self._axis_size = 1 if mesh is None else self.sharding.world
        if mesh is not None:
            replicate(self.model, mesh)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        f32_matmuls()  # the FC funnel runs in cuBLAS; the JAX side is full f32
        if compute_dtype(model_kwargs.get("dtype")) == torch.bfloat16:
            bf16_matmuls()  # its bf16 products accumulate in f32, as XLA's

    def _hold_int8(self, model: nn.Module, params: Dict, scales: Dict) -> Dict:
        """Keep each scaled kernel of ``params`` and its scale on the device,
        and return ``params`` with those kernels dequantized on the host,
        for the module's shapes only (their weights are dropped after the
        load)."""
        kernels = kernel_parameters(model)
        unknown = sorted(set(scales) - set(kernels))
        if unknown:
            raise KeyError(f"scales for kernels {model.__class__.__name__} does not have: "
                           f"{unknown}")
        self._int8 = {path: kernels[path] for path in scales}

        def hold(path, leaf):
            if path not in scales:
                return leaf
            q, scale = np.asarray(leaf), np.asarray(scales[path], np.float32)
            if q.dtype != np.int8:
                raise ValueError(f"{path}: scales= takes int8 kernels, got {q.dtype}")
            self._quantized[path] = torch.from_numpy(q.copy()).to(self.device)
            self._scales[path] = torch.from_numpy(scale.copy()).to(self.device)
            return q.astype(np.float32) * scale

        return map_leaves(params, hold)

    def param_bytes(self) -> Dict[str, int]:
        """Bytes of the weights held on the device: the module's parameters
        and BatchNorm statistics (``module``), the int8 kernels (``int8``)
        and their scales (``scales``)."""
        tensors = {"module": [t for m in self.members for t in (*m.parameters(), *m.buffers())],
                   "int8": list(self._quantized.values()), "scales": list(self._scales.values())}
        return {k: sum(t.numel() * t.element_size() for t in v) for k, v in tensors.items()}

    def _apply(self, pts: torch.Tensor):
        """The model on a padded bucket: through the dequantized int8
        kernels when there are any; on the stacked views when ``tta_views >
        1``; once a member, each from the same generator state, when
        ``ensemble_size > 1``; then the combine."""
        if self.tta_views > 1:
            pts = rotate_views(pts, self._rots)
        if self._quantized:
            deq = dequantize_params(self._quantized, self._scales)
            weights = {name: deq[path].reshape(cin, -1).t() for path, (name, cin)
                       in self._int8.items()}
            out = functional_call(self.model, weights, (pts, self.generator))
        elif self.ensemble_size > 1:
            state = self.generator.get_state()
            outs = []
            for member in self.members:
                self.generator.set_state(state)
                outs.append(member(pts, self.generator))
            out = (tuple(torch.cat(o) for o in zip(*outs)) if isinstance(outs[0], tuple)
                   else torch.cat(outs))
        else:
            out = self.model(pts, self.generator)
        if self.tta_views == 1 and self.ensemble_size == 1:
            return out
        return tta_combine(self._tta_mode, out, self._angles, self._rots, self.ensemble_size)

    @classmethod
    def from_torch_checkpoint(cls, path: str, model: str = "pointnet_pp_8dir",
                              **kw) -> "OrientationPredictor":
        """Serve a reference-layout ``.pth`` (a raw ``state_dict`` of the
        reference's ``model``, or one that ``utils/torch_export.py`` wrote);
        ``kw`` as the constructor's."""
        from .utils.torch_import import load_torch_checkpoint

        params, stats = load_torch_checkpoint(path, model)
        return cls(model, params, stats, **kw)

    @classmethod
    def from_orbax_checkpoint(cls, path: str, model: str, **kw) -> "OrientationPredictor":
        """Serve the JAX package's Orbax checkpoint ``path`` (a ``step_<N>``
        directory of its ``Trainer.save_checkpoint``, or the port's
        :meth:`.train.Trainer.save_orbax_checkpoint`): its ``params`` and
        ``batch_stats``, read by :func:`.utils.orbax_format.read_pytree`
        without orbax; ``kw`` as the constructor's."""
        from .utils.orbax_format import read_pytree

        ckpt = read_pytree(path)
        return cls(model, ckpt["params"], ckpt.get("batch_stats"), **kw)

    @classmethod
    def from_quantized_checkpoint(cls, path: str, model: str, **kw) -> "OrientationPredictor":
        """Serve an int8 ``.npz`` artifact
        (:func:`.utils.quantize.save_quantized_checkpoint`, or the JAX
        package's); ``kw`` as the constructor's."""
        from .utils.quantize import load_quantized_checkpoint

        quantized, scales, batch_stats = load_quantized_checkpoint(path)
        return cls(model, quantized, batch_stats, scales=scales, **kw)

    @classmethod
    def from_seed_sweep(cls, model: str, members, **kw) -> "OrientationPredictor":
        """A deep ensemble from per-member weight trees, e.g. the multi-seed
        protocol's (``train.multiseed.run_multi_seed(...,
        return_params=True)``)::

            res = run_multi_seed(cfg, ds, seeds=[42, 43, 44], return_params=True)
            pred = OrientationPredictor.from_seed_sweep(cfg.model, [res[s] for s in sorted(res)])

        ``members``: ``{"params": tree, "batch_stats": tree}`` dicts
        (``batch_stats`` present for every member or none), stacked on a
        leading member axis; one member serves as the plain predictor."""
        members = list(members)
        if not members:
            raise ValueError("from_seed_sweep needs at least one member")
        if len(members) == 1:
            return cls(model, members[0]["params"], members[0].get("batch_stats"), **kw)
        stats = [m.get("batch_stats") for m in members]
        if any(s is not None for s in stats) and any(s is None for s in stats):
            raise ValueError("batch_stats must be present for every member or none")
        return cls(model, _stack([m["params"] for m in members]),
                   _stack(stats) if stats[0] is not None else None,
                   ensemble_size=len(members), **kw)

    @classmethod
    def from_protocol_checkpoint(cls, path: str, model: str, members=None,
                                 **kw) -> "OrientationPredictor":
        """A deep ensemble from a multi-seed protocol checkpoint's
        ``step_<E>`` directory (``--seeds ... --checkpoint-every``,
        ``train/protocol_ckpt.py``): each member's best-val weights;
        ``members`` selects some by index.

        Not for the per-label protocol's checkpoints (the same layout): their
        members answer different questions, and averaging them is not an
        ensemble. ``history.json``'s keys must parse as seeds unless
        ``allow_label_keys=True`` (``ValueError``). A member whose val loss
        never improved (non-finite ``best_val``) is left out by default, with
        a warning; selected by ``members``, it serves its final weights (the
        JAX package's slot holds its initial ones), with a warning. A JAX
        package's checkpoint (an Orbax ``carry/``) is read as the JAX
        predictor reads it: every member's ``best_params`` and
        ``best_batch_stats``, the initial weights where ``best_val`` never
        improved."""
        import json
        import warnings

        from .train.config import TrainConfig
        from .train.protocol_ckpt import read_protocol_carry
        from .train.trainer import config_model_kwargs
        from .utils.jax_weights import to_flax_variables

        allow_label_keys = kw.pop("allow_label_keys", False)
        hist_path = os.path.join(path, "history.json")
        if not allow_label_keys and os.path.exists(hist_path):
            with open(hist_path) as f:
                keys = json.load(f).get("keys", [])
            try:
                [int(k) for k in keys]
            except (TypeError, ValueError):
                raise ValueError(
                    f"checkpoint at {path} has non-seed keys {keys!r} — this looks like a "
                    "per-LABEL protocol checkpoint (per-class models; averaging them is not "
                    "an ensemble). Pass allow_label_keys=True to override.") from None
        carry = read_protocol_carry(path)
        states, configs = carry["members"], carry["configs"]
        jax_carry = configs is None
        finite = np.isfinite(np.asarray([np.asarray(s["best_val"]) for s in states], np.float64))
        if members is None and not finite.all():
            warnings.warn(f"protocol checkpoint members {np.nonzero(~finite)[0].tolist()} have "
                          "non-finite best_val (validation never improved) — excluding them "
                          "from the ensemble. Pass members= explicitly to override.",
                          stacklevel=2)
            members = np.nonzero(finite)[0].tolist()
        idx = list(range(len(states))) if members is None else [int(i) for i in members]
        if not idx:
            raise ValueError(f"no usable ensemble members in {path}: every saved best_val is "
                             "non-finite (all seeds diverged).")
        if not finite[idx].all():
            warnings.warn(f"selected members {[i for i in idx if not finite[i]]} have "
                          "non-finite best_val — they serve their "
                          + ("initial" if jax_carry else "final") + " weights.", stacklevel=2)
        if jax_carry:
            return cls.from_seed_sweep(model, [
                {"params": states[i]["best_params"],
                 "batch_stats": states[i].get("best_batch_stats") or None} for i in idx], **kw)
        trees = []
        for i in idx:
            cfg = TrainConfig(**configs[i])
            if cfg.model != model:
                raise ValueError(f"{path} member {i} trained {cfg.model!r}, not {model!r}")
            module = MODEL_REGISTRY[model](**config_model_kwargs(cfg))
            state = states[i]
            module.load_state_dict(state["best_state"] if state["best_state"] is not None
                                   else state["model"])
            trees.append(to_flax_variables(module))
        stats = [t["batch_stats"] or None for t in trees]
        return cls.from_seed_sweep(model, [{"params": t["params"], "batch_stats": s}
                                           for t, s in zip(trees, stats)], **kw)

    def _bucket(self, b: int) -> int:
        """The power of two from the axis size up to ``b``, clamped to
        ``max_batch`` rounded up to a multiple of the axis size (1 without
        a mesh), as the JAX predictor's buckets."""
        bucket = self._axis_size
        while bucket < b:
            bucket *= 2
        axis = self._axis_size
        return min(bucket, -(-max(self.max_batch, axis) // axis) * axis)

    def _pad(self, clouds: np.ndarray) -> np.ndarray:
        """Points by cycling or truncation to ``num_points``; batch by
        repeating the first cloud up to the bucket."""
        b, n = clouds.shape[0], clouds.shape[1]
        if n < self.num_points:
            reps = -(-self.num_points // n)
            clouds = np.tile(clouds, (1, reps, 1))[:, : self.num_points]
        elif n > self.num_points:
            clouds = clouds[:, : self.num_points]
        bucket = self._bucket(b)
        if b < bucket:
            clouds = np.concatenate([clouds, np.repeat(clouds[:1], bucket - b, axis=0)], axis=0)
        return clouds

    @torch.inference_mode()
    def __call__(self, clouds: np.ndarray) -> Output:
        """The model's native output for ``(B, N, C)`` clouds, any B and N, C
        the model's input width, for the original B: logits ``(B, 8)``
        (8-dir), unit vectors ``(B, 3)`` (forward), the tuple ``(mu (B,),
        kappa (B,))`` (vM) or ``(mu, kappa, weight)``, each ``(B, max_K)``
        (MvM; ``(B, V * max_K)`` under TTA), raw vectors ``(B, 3)``
        (``pointnet_pp``, ``simple_pointnet``, ``pointnet``, the
        transformer), the tuple of two ``(B, 3)`` axes (the two-axis heads),
        log-probabilities ``(B, num_classes)`` (``pointnet_pp_cls``), the
        tuple ``(log-probabilities, feature transform (B, 64, 64))``
        (``pointnet_cls``); above ``max_batch`` the request is served in
        chunks of ``max_batch``."""
        clouds = np.asarray(clouds, np.float32)
        c = self.channels
        if clouds.ndim != 3 or clouds.shape[-1] != c or clouds.shape[0] < 1 or clouds.shape[1] < 1:
            raise ValueError(f"clouds must be (B>=1, N>=1, {c}), got {clouds.shape}")
        b = clouds.shape[0]
        if b > self.max_batch:
            chunks = [self(clouds[i: i + self.max_batch]) for i in range(0, b, self.max_batch)]
            if isinstance(chunks[0], tuple):
                return tuple(np.concatenate(xs, axis=0) for xs in zip(*chunks))
            return np.concatenate(chunks, axis=0)
        pts = torch.from_numpy(np.ascontiguousarray(self._pad(clouds))).to(self.device)
        if self.sharding is None:
            out = self._apply(pts)
        else:
            with batch_shard(self.sharding):
                out = self._apply(pts[self.sharding.rows(pts.shape[0])])
            group = self.sharding.group
            out = (tuple(all_gather_cat(o, group) for o in out) if isinstance(out, tuple)
                   else all_gather_cat(out, group))
        if isinstance(out, tuple):
            return tuple(o[:b].cpu().numpy() for o in out)
        return out[:b].cpu().numpy()

    def forward_vectors(self, clouds: np.ndarray) -> np.ndarray:
        """The JAX predictor's decode to unit forward vectors ``(B, 3)``: for
        8-dir the softmax of the logits times ``DIRS_8``; for vM ``(sin mu,
        0, -cos mu)``; for MvM the same of the heaviest component's mu; for
        the two-axis heads the last head's output (forward; ``head_y`` for
        ``pointnet_pp_xyz``); the forward heads' output as it is (and the
        classifier's ``(B, num_classes)``, as the JAX package's fall-through
        branch does); normalised. ``pointnet_cls``'s tuple has no such
        decode (``ValueError``; the JAX fall-through fails on it too)."""
        if self.model_name == "pointnet_cls":
            raise ValueError("pointnet_cls returns (log_probs, trans_feat): no forward vector")
        out = self(clouds)
        if self.model_name == "pointnet_pp_8dir":
            out = (torch.softmax(torch.from_numpy(out), dim=-1) @ DIRS_8).numpy()
        elif self.model_name in ("pointnet_pp_von_mises", "pointnet_pp_mvm"):
            mu = out[0]
            if self.model_name == "pointnet_pp_mvm":
                mu = np.take_along_axis(mu, np.argmax(out[2], -1)[:, None], 1)[:, 0]
            out = np.stack([np.sin(mu), np.zeros_like(mu), -np.cos(mu)], -1)
        elif self.model_name in ("pointnet_pp_xyz", "pointnet_pp_xyz_schmidt"):
            out = out[-1]
        return out / (np.linalg.norm(out, axis=-1, keepdims=True) + 1e-12)
