"""Batched serving of the PointNet++ models and the point transformer on
the card.

Counterpart of ``pointcloud_orientation_tpu/infer.py`` ``OrientationPredictor``
for the models ``pointnet_pp_8dir`` (8-way direction logits),
``pointnet_pp_fwd`` (unit forward vectors), ``pointnet_pp_von_mises`` ((mu,
kappa)), ``pointnet_pp_mvm`` ((mu, kappa, weight)), ``pointnet_pp`` (raw
forward vectors), ``pointnet_pp_xyz`` ((x, y) axes),
``pointnet_pp_xyz_schmidt`` ((up, forward)), ``pointnet_pp_cls``
(ModelNet40 log-probabilities) and ``point_transformer`` (raw forward
vectors; ``attention_impl="flash"`` through the flash kernels) in eval
mode, one view, one ensemble member, no quantization, one device; f32, or
bf16 (``dtype="bfloat16"``, the JAX package's ``**model_kwargs``).
Requests are padded to power-of-two batch buckets (clamped to
``max_batch``) and to ``num_points`` points, exactly as the JAX predictor
pads them.

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

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .models import MODEL_REGISTRY
from .ops import DIRS_8
from .models.layers import compute_dtype
from .ops.cuda_kernels import bf16_matmuls, f32_matmuls
from .utils.jax_weights import load_flax_variables, model_kwargs as tree_kwargs

Output = Union[np.ndarray, Tuple[np.ndarray, ...]]


class OrientationPredictor:
    """Bucketed predictor over one of the port's PointNet++ models
    (``MODEL_REGISTRY``).

    ``params``/``batch_stats`` are the JAX package's flax trees as numpy
    arrays (see :mod:`.utils.jax_weights`); what the tree fixes is read from
    it (the classifier's input width and class count, the vM head's mu
    parameterisation, the MvM head's ``max_K``). Runs on
    ``device`` ("cuda" unless the caller asks for the CPU). Random centroids
    and FPS start points are drawn from a ``torch.Generator`` seeded with
    ``seed``; they match the JAX predictor's only in distribution
    (``sampling="first"`` makes the 8-dir model deterministic).
    ``model_kwargs`` go to the model: ``dtype=torch.bfloat16`` (or
    ``"bfloat16"``) serves a BatchNorm trunk in bf16; ``sampling`` and
    ``grouping`` of a trunk head, the MvM head's ``temp``, ``kappa_max`` and
    ``weight_floor``, the two-axis heads' ``normalize_heads`` and
    ``gram_schmidt``, the transformer's ``attention_impl`` (``"xla"`` or
    ``"flash"``; the flash kernels take ``num_points`` in multiples of
    128) and ``dtype``.
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
        tta_views: int = 1,
        ensemble_size: int = 1,
        device: str | torch.device = "cuda",
        **model_kwargs: Any,
    ):
        if model_name not in MODEL_REGISTRY:
            raise NotImplementedError(
                f"model {model_name!r} is not ported; the port serves {sorted(MODEL_REGISTRY)}")
        for name, value, default in (("quantize", quantize, None), ("scales", scales, None),
                                     ("mesh", mesh, None), ("tta_views", tta_views, 1),
                                     ("ensemble_size", ensemble_size, 1)):
            if value != default:
                raise NotImplementedError(f"{name}={value!r} is not ported")
        if num_points < 1 or max_batch < 1:
            raise ValueError(f"num_points={num_points} and max_batch={max_batch} must be >= 1")
        self.device = torch.device(device)
        self.model_name = model_name
        self.num_points = num_points
        self.max_batch = max_batch
        model_kwargs = {**tree_kwargs(model_name, params), **model_kwargs}
        model = MODEL_REGISTRY[model_name](**model_kwargs)
        self.channels = getattr(model, "in_channels", 3)
        load_flax_variables(model, {"params": params, "batch_stats": batch_stats})
        self.model = model.to(self.device).eval()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        f32_matmuls()  # the FC funnel runs in cuBLAS; the JAX side is full f32
        if compute_dtype(model_kwargs.get("dtype")) == torch.bfloat16:
            bf16_matmuls()  # its bf16 products accumulate in f32, as XLA's

    @classmethod
    def from_torch_checkpoint(cls, path: str, model: str = "pointnet_pp_8dir",
                              **kw) -> "OrientationPredictor":
        """Serve a reference-layout ``.pth`` (a raw ``state_dict`` of the
        reference's ``model``, or one that ``utils/torch_export.py`` wrote);
        ``kw`` as the constructor's."""
        from .utils.torch_import import load_torch_checkpoint

        params, stats = load_torch_checkpoint(path, model)
        return cls(model, params, stats, **kw)

    def _bucket(self, b: int) -> int:
        bucket = 1
        while bucket < b:
            bucket *= 2
        return min(bucket, self.max_batch)

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
        (MvM), raw vectors ``(B, 3)`` (``pointnet_pp``), the tuple of two
        ``(B, 3)`` axes (the two-axis heads), log-probabilities ``(B,
        num_classes)`` (classifier); above
        ``max_batch`` the request is served in chunks of ``max_batch``."""
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
        out = self.model(pts, self.generator)
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
        branch does); normalised."""
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
