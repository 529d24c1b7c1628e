"""Training: optimizers and schedules (``optim``) and the step/epoch loop
(``trainer``)."""

from .optim import get_lr_schedule, get_optimizer
from .trainer import Trainer

__all__ = ["Trainer", "get_lr_schedule", "get_optimizer"]
