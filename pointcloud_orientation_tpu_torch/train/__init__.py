"""Training of the port: configuration, task adapters, metrics, the
single-GPU ``Trainer`` (with ``reliability.PreemptionGuard``), the lockstep
protocols (``ensemble``, ``multiseed``, ``protocol_ckpt``), gradient
accumulation (``accum``) and the ``run`` CLI."""

from .accum import accumulated_value_and_grad, make_accum_train_step
from .config import PRESETS, TrainConfig, preset
from .metrics import MetricsAccumulator, write_summary_txt
from .reliability import PreemptionGuard
from .tasks import TASKS, TaskAdapter
from .trainer import Trainer

__all__ = ["MetricsAccumulator", "PRESETS", "PreemptionGuard", "TASKS", "TaskAdapter",
           "TrainConfig", "Trainer", "accumulated_value_and_grad", "make_accum_train_step",
           "preset", "write_summary_txt"]
