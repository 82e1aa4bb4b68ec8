"""Optimizer pieces and schedules."""

from .optim import clip_by_global_norm, make_scheduler, sgd_update  # noqa: F401
