"""Optimizers and learning-rate schedules (port of ``src/repro/optim``)."""

from .optimizers import (OptState, adafactor, adamw, apply_updates,
                         clip_by_global_norm, make_optimizer,
                         state_logical_axes)
from .schedules import cosine_with_warmup, linear_warmup

__all__ = ["OptState", "adamw", "adafactor", "apply_updates",
           "clip_by_global_norm", "make_optimizer", "state_logical_axes",
           "cosine_with_warmup", "linear_warmup"]
