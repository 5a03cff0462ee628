"""LM training: the fault-tolerant loop (port of ``src/repro/train``)."""

from .loop import TrainConfig, Trainer, compute_grads, make_train_step

__all__ = ["TrainConfig", "Trainer", "compute_grads", "make_train_step"]
