"""Training of the port: configuration, task adapters, metrics, the
single-GPU ``Trainer`` and the ``run`` CLI."""

from .config import PRESETS, TrainConfig, preset
from .trainer import Trainer

__all__ = ["PRESETS", "TrainConfig", "Trainer", "preset"]
