"""Training configuration of the port.

Counterpart of ``pointcloud_orientation_tpu/train/config.py`` for the fields
the PointNet++ and PointNet tasks use and their presets: ``simple_pointnet``
(SimplePointNet, ``forward_mse`` on axes row 0, SO(3) rotations, one
category), the SO(3) tasks
``pointnet_pp_forward`` (PointNetPP, ``forward_mse`` on axes row
``target_row``) and ``axes_all_labels`` (PointNetPPXYZSchmidt, task
``axes``, one model per label), ``8dir`` (per label), ``8dir_kl`` and
``8dir_mse`` (PointNetPP8Dir), ``multi_8dir`` (PointNetPPFwd), ``vm_kl`` and
``vm_kl_atan2`` (PointNetPPVonMises), and ``mvm``, ``mvm_guarded``,
``mvm_spread``, ``mvm_robust`` and ``mvm_debug`` (PointNetPPMvM, the twelve
MvM categories, 100 epochs, gradient clip 1.0): N=10,000, B=16, Adam at
1e-3, seed 42, rotations ``yaw``, ``so3`` or ``none``, with
``compute_dtype`` None/"float32" or
"bfloat16" (the trunk's compute type). The ``point_transformer`` preset
trains the point transformer on ``forward_mse`` (SO(3) rotations, one
category, N=1,024) with ``transformer_attention`` "xla" or "flash" (the
flash kernels, O(N) attention memory). The
``classification`` task trains ``pointnet_pp_cls`` or ``pointnet_cls``
(whose loss reads the first of its outputs, the log-probabilities); no
preset names it, as in the JAX package: ``TrainConfig(task="classification",
model="pointnet_pp_cls")``. ``pointnet`` (PointNet regression) trains on the
vector tasks by config. ``optimizer`` ("adam", the reference's, or
"sgd"), ``lr_schedule`` (None, the reference's constant rate, or "cosine"
with ``warmup_epochs`` of linear warmup), ``async_checkpoint``,
``host_resident`` and ``keep_best`` are the JAX config's. ``host_resident``
streams one batch a step from the host, for splits larger than the card,
in place of the device-resident splits (the fit, ``test`` and the
protocols' members; see :class:`.trainer.Trainer`); ``keep_best`` changes
nothing here, as there. The MoE point
transformer (preset ``moe_point_transformer``, task ``forward_mse_aux``)
takes ``moe_experts``, ``moe_aux_weight``, ``moe_dispatch`` ("masked" or
"capacity") and ``moe_capacity_factor``. ``bn_sync_axis`` is the JAX
config's field; a data-parallel ``Trainer`` already takes BatchNorm's
statistics over the global batch, and any value but None raises there, as
the JAX ``Trainer`` fails on it (:class:`.trainer.Trainer`).
``ring_point_transformer`` is a model name the config takes, as the JAX
config does, and no ``Trainer`` trains (its forward has no train mode:
``parallel.make_sp_train_step`` trains it); :func:`preset` raises the JAX
``KeyError`` for a name that is not a preset.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..data.pipeline import ROTATION_MODES

SIX_CLASS_MIX: Tuple[str, ...] = ("chair", "toilet", "sofa", "plant", "bowl", "bottle")

# The 12-category MvM scope.
MVM_CLASSES: Tuple[str, ...] = (
    "cone", "bowl", "chair", "bottle", "plant", "car",
    "sofa", "toilet", "door", "curtain", "bathtub", "glass_box",
)

PORTED_TASKS = ("forward_mse", "forward_mse_aux", "axes", "8dir_kl", "8dir_mse", "multi_8dir",
                "vm_kl", "mvm", "classification")
PORTED_MODELS = ("pointnet_pp", "pointnet_pp_xyz", "pointnet_pp_xyz_schmidt",
                 "pointnet_pp_8dir", "pointnet_pp_fwd", "pointnet_pp_von_mises",
                 "pointnet_pp_mvm", "pointnet_pp_cls", "point_transformer",
                 "moe_point_transformer", "simple_pointnet", "pointnet", "pointnet_cls",
                 "ring_point_transformer")
PORTED_COMPUTE_DTYPES = (None, "float32", "bfloat16")

# Fields of the JAX package's TrainConfig that the port does not carry,
# with their defaults there: none since bn_sync_axis.
UNPORTED_DEFAULTS: dict = {}


@dataclasses.dataclass
class TrainConfig:
    # task + model
    task: str = "8dir_kl"
    model: str = "pointnet_pp_8dir"
    # data
    num_points: int = 1024
    rotation_mode: str = "yaw"  # "yaw" | "so3" | "none"
    classes: Optional[Sequence[str]] = SIX_CLASS_MIX
    per_label: bool = False  # one model per category (train/run.py run_per_label)
    target_row: int = 2  # the axes row forward_mse regresses (2 = forward)
    # optimization
    batch_size: int = 16
    epochs: int = 200
    lr: float = 1e-3
    # None: the reference's constant lr; "cosine": cosine decay from lr to 0
    # over `epochs`, after `warmup_epochs` of linear warmup from 0
    lr_schedule: Optional[str] = None
    warmup_epochs: int = 0
    optimizer: str = "adam"  # "adam" (the reference's) or "sgd"
    seed: int = 42
    grad_clip: Optional[float] = None
    compute_dtype: Optional[str] = None  # "bfloat16": the trunk computes in bf16
    lambda_orth: float = 0.1  # the axes task's orthogonality weight
    # the axes task's ablations: orthogonalise up against forward; raw heads
    axes_gram_schmidt: bool = False
    axes_normalize_heads: bool = True
    # the point transformer's attention: "xla" (plain) or "flash" (the flash
    # kernels, O(N) attention memory; applies no attention-probability dropout)
    transformer_attention: str = "xla"
    # distribution heads
    kappa_default: float = 8.0
    max_k: int = 4
    # the MoE transformer (task "forward_mse_aux")
    moe_experts: int = 4
    moe_aux_weight: float = 0.01  # the switch load-balance coefficient
    moe_dispatch: str = "masked"  # "capacity": the switch gather dispatch
    moe_capacity_factor: float = 1.25  # slots an expert: T/K * factor
    # the JAX package's improvements over the reference (0/"zero"/"tanh" = parity)
    mvm_unmatched_penalty: float = 0.0  # guard against the weight-collapse minimum
    mvm_weight_floor: float = 0.0  # w = (1-f)*softmax + f/K
    mvm_mu_init: str = "zero"  # "spread": component mus start around the circle
    vm_mu_parameterization: str = "tanh"  # "atan2": the wrap-free mu head
    # runtime
    out_dir: str = "results"
    checkpoint_every: int = 0  # epochs between checkpoints (0 = off)
    async_checkpoint: bool = False  # periodic checkpoints written on a background thread
    keep_best: bool = True  # read nowhere, as in the JAX package
    debug_checks: bool = False  # per-step finite checks and debug_log.txt in out_dir
    # stream one batch a step from the host (splits larger than the card)
    # instead of keeping the splits on the device, as in the JAX package
    host_resident: bool = False
    # the JAX config's BatchNorm sync axis; the port's data parallelism is
    # global-batch already, and a Trainer refuses any value but None
    bn_sync_axis: Optional[str] = None

    def __post_init__(self):
        checks = (
            ("task", self.task in PORTED_TASKS, f"one of {PORTED_TASKS}"),
            ("model", self.model in PORTED_MODELS, f"one of {PORTED_MODELS}"),
            ("rotation_mode", self.rotation_mode in ROTATION_MODES, f"one of {ROTATION_MODES}"),
            ("compute_dtype", self.compute_dtype in PORTED_COMPUTE_DTYPES,
             f"one of {PORTED_COMPUTE_DTYPES}"),
            ("vm_mu_parameterization", self.vm_mu_parameterization in ("tanh", "atan2"),
             "'tanh' or 'atan2'"),
            ("mvm_mu_init", self.mvm_mu_init in ("zero", "spread"), "'zero' or 'spread'"),
            ("transformer_attention", self.transformer_attention in ("xla", "flash"),
             "'xla' or 'flash'"),
        )
        for name, ok, ported in checks:
            if not ok:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported; the port takes {ported}")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


PRESETS = {
    # simple_pointnet_train.py: SimplePointNet, MSE on the first axes row,
    # one category (chair), SO(3)-rotated
    "simple_pointnet": TrainConfig(task="forward_mse", model="simple_pointnet",
                                   rotation_mode="so3", classes=("chair",), target_row=0,
                                   num_points=10_000),
    # PointNet++_train.py: inline PointNetPP, MSE forward, one category
    "pointnet_pp_forward": TrainConfig(task="forward_mse", model="pointnet_pp",
                                       rotation_mode="so3", classes=("bookshelf",),
                                       target_row=0, num_points=10_000),
    # train.py: two-axis + orthogonality over all 40 labels, per-label loop
    "axes_all_labels": TrainConfig(task="axes", model="pointnet_pp_xyz_schmidt",
                                   rotation_mode="so3", classes=None, per_label=True,
                                   num_points=10_000, lambda_orth=0.1),
    # train_8dir.py: 8-dir softmax-MSE, per label (chair), yaw rotations
    # the point transformer (models/point_transformer.py): MSE forward, one category
    "point_transformer": TrainConfig(task="forward_mse", model="point_transformer",
                                     rotation_mode="so3", classes=("chair",), num_points=1024),
    # the conditional-capacity variant: the same data and objective, MoE FFNs
    # and the switch aux loss
    "moe_point_transformer": TrainConfig(task="forward_mse_aux", model="moe_point_transformer",
                                         rotation_mode="so3", classes=("chair",),
                                         num_points=1024),
    "8dir": TrainConfig(task="8dir_mse", model="pointnet_pp_8dir", rotation_mode="yaw",
                        classes=("chair",), per_label=True, num_points=10_000),
    # train_8dir_MSE.py: 8-dir softmax-MSE, 6-class mix
    "8dir_mse": TrainConfig(task="8dir_mse", rotation_mode="yaw", classes=SIX_CLASS_MIX,
                            num_points=10_000),
    # train_8dir_KL.py: 8-dir soft-label KL, 6-class mix
    "8dir_kl": TrainConfig(task="8dir_kl", rotation_mode="yaw", classes=SIX_CLASS_MIX,
                           num_points=10_000),
    # train_multi_8dir.py: unit-forward head projected to 8-dir, MSE
    "multi_8dir": TrainConfig(task="multi_8dir", model="pointnet_pp_fwd", rotation_mode="yaw",
                              classes=SIX_CLASS_MIX, num_points=10_000),
    # train_single_peak_vonMises_KL.py: single-peak vM KL, 6-class mix
    "vm_kl": TrainConfig(task="vm_kl", model="pointnet_pp_von_mises", rotation_mode="yaw",
                         classes=SIX_CLASS_MIX, num_points=10_000),
    # the same with the wrap-free atan2 mu head
    "vm_kl_atan2": TrainConfig(task="vm_kl", model="pointnet_pp_von_mises", rotation_mode="yaw",
                               classes=SIX_CLASS_MIX, num_points=10_000,
                               vm_mu_parameterization="atan2"),
    # matched MvM with the unmatched-weight penalty
    "mvm_guarded": TrainConfig(task="mvm", model="pointnet_pp_mvm", rotation_mode="yaw",
                               classes=MVM_CLASSES, epochs=100, grad_clip=1.0,
                               num_points=10_000, mvm_unmatched_penalty=1.0),
    # matched MvM, component mus initialised around the circle
    "mvm_spread": TrainConfig(task="mvm", model="pointnet_pp_mvm", rotation_mode="yaw",
                              classes=MVM_CLASSES, epochs=100, grad_clip=1.0,
                              num_points=10_000, mvm_mu_init="spread"),
    # matched MvM with a weight floor and the spread init
    "mvm_robust": TrainConfig(task="mvm", model="pointnet_pp_mvm", rotation_mode="yaw",
                              classes=MVM_CLASSES, epochs=100, grad_clip=1.0,
                              num_points=10_000, mvm_weight_floor=0.1, mvm_mu_init="spread"),
    # train_multi_peaks_vonMises_KL.py: matched MvM KL, 12 categories
    "mvm": TrainConfig(task="mvm", model="pointnet_pp_mvm", rotation_mode="yaw",
                       classes=MVM_CLASSES, epochs=100, grad_clip=1.0, num_points=10_000),
    # train_multi_peaks_vonMises_KL_debug.py: the same with per-step finite checks
    "mvm_debug": TrainConfig(task="mvm", model="pointnet_pp_mvm", rotation_mode="yaw",
                             classes=MVM_CLASSES, epochs=100, grad_clip=1.0,
                             num_points=10_000, debug_checks=True),
}


def preset(name: str, **overrides) -> TrainConfig:
    """The preset ``name`` with ``overrides``; ``KeyError``, as the JAX
    package's, for a name that is not a preset."""
    return PRESETS[name].replace(**overrides)
