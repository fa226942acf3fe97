"""Training configuration of the port.

Counterpart of ``pointcloud_orientation_tpu/train/config.py`` for the fields
the 8-direction slice uses and its two presets, ``8dir_kl`` and
``8dir_mse`` (PointNetPP8Dir, yaw rotations, the six-class mix, N=10,000,
B=16, Adam at 1e-3, seed 42), with ``compute_dtype`` None/"float32" or
"bfloat16" (the trunk's compute type). The JAX config's other fields are
accepted by :func:`preset` and :meth:`TrainConfig.replace` at their default
values only; any other value raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

SIX_CLASS_MIX: Tuple[str, ...] = ("chair", "toilet", "sofa", "plant", "bowl", "bottle")

PORTED_TASKS = ("8dir_kl", "8dir_mse")
PORTED_COMPUTE_DTYPES = (None, "float32", "bfloat16")

# Fields of the JAX package's TrainConfig that this slice does not carry,
# with their defaults there.
UNPORTED_DEFAULTS = {
    "per_label": False,
    "target_row": 2,
    "optimizer": "adam",
    "lr_schedule": None,
    "warmup_epochs": 0,
    "lambda_orth": 0.1,
    "axes_gram_schmidt": False,
    "axes_normalize_heads": True,
    "transformer_attention": "xla",
    "moe_experts": 4,
    "moe_aux_weight": 0.01,
    "moe_dispatch": "masked",
    "moe_capacity_factor": 1.25,
    "mvm_unmatched_penalty": 0.0,
    "mvm_weight_floor": 0.0,
    "mvm_mu_init": "zero",
    "vm_mu_parameterization": "tanh",
    "async_checkpoint": False,
    "debug_checks": False,
    "host_resident": False,
    "bn_sync_axis": None,
    "kappa_default": 8.0,
    "max_k": 4,
    "keep_best": True,
}


@dataclasses.dataclass
class TrainConfig:
    # task + model
    task: str = "8dir_kl"
    model: str = "pointnet_pp_8dir"
    # data
    num_points: int = 1024
    rotation_mode: str = "yaw"
    classes: Optional[Sequence[str]] = SIX_CLASS_MIX
    # optimization (Adam)
    batch_size: int = 16
    epochs: int = 200
    lr: float = 1e-3
    seed: int = 42
    grad_clip: Optional[float] = None
    compute_dtype: Optional[str] = None  # "bfloat16": the trunk computes in bf16
    # runtime
    out_dir: str = "results"
    checkpoint_every: int = 0  # epochs between checkpoints (0 = off)

    def __post_init__(self):
        checks = (
            ("task", self.task in PORTED_TASKS, f"one of {PORTED_TASKS}"),
            ("model", self.model == "pointnet_pp_8dir", "'pointnet_pp_8dir'"),
            ("rotation_mode", self.rotation_mode == "yaw", "'yaw'"),
            ("compute_dtype", self.compute_dtype in PORTED_COMPUTE_DTYPES,
             f"one of {PORTED_COMPUTE_DTYPES}"),
        )
        for name, ok, ported in checks:
            if not ok:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported; the port takes {ported}")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **_ported_overrides(kw))


def _ported_overrides(kw: dict) -> dict:
    out = {}
    for name, value in kw.items():
        if name in UNPORTED_DEFAULTS:
            if value != UNPORTED_DEFAULTS[name]:
                raise NotImplementedError(f"{name}={value!r} is not ported")
            continue
        out[name] = value
    return out


PRESETS = {
    # train_8dir_MSE.py: 8-dir softmax-MSE, 6-class mix
    "8dir_mse": TrainConfig(task="8dir_mse", rotation_mode="yaw", classes=SIX_CLASS_MIX,
                            num_points=10_000),
    # train_8dir_KL.py: 8-dir soft-label KL, 6-class mix
    "8dir_kl": TrainConfig(task="8dir_kl", rotation_mode="yaw", classes=SIX_CLASS_MIX,
                           num_points=10_000),
}


def preset(name: str, **overrides) -> TrainConfig:
    if name not in PRESETS:
        raise NotImplementedError(f"preset {name!r} is not ported; the port has {sorted(PRESETS)}")
    return PRESETS[name].replace(**overrides)
