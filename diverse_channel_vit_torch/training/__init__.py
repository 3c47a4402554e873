"""Training of the port (counterpart of the JAX package's ``training/``):
schedules, the AdamW optimizer, the train state and the train step."""

from .optim import AdamW, make_optimizer
from .schedules import make_lr_schedule, timm_cosine_schedule, wd_cosine_schedule
from .state import TrainState
from .steps import make_train_step

__all__ = [
    "AdamW",
    "TrainState",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "timm_cosine_schedule",
    "wd_cosine_schedule",
]
