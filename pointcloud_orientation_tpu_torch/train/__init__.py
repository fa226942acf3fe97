"""Training of the port: configuration, task adapters, metrics, the
single-GPU ``Trainer`` (with ``reliability.PreemptionGuard``), the lockstep
protocols (``ensemble``, ``multiseed``, ``protocol_ckpt``), gradient
accumulation (``accum``) and the ``run`` CLI."""

from .config import PRESETS, TrainConfig, preset
from .trainer import Trainer

__all__ = ["PRESETS", "TrainConfig", "Trainer", "preset"]
