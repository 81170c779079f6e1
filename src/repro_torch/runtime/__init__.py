"""The port's fault-tolerant training runtime."""
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
