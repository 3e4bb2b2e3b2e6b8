"""Optimizers (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (
    Optimizer,
    adagrad,
    adam,
    apply_updates,
    clip_by_global_norm,
    momentum,
    sgd,
    warmup_cosine,
)

__all__ = [
    "Optimizer",
    "adagrad",
    "adam",
    "apply_updates",
    "clip_by_global_norm",
    "momentum",
    "sgd",
    "warmup_cosine",
]
