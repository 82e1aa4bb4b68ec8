"""Optimizer pieces, schedules and metrics."""

from .metrics import summarize_sums  # noqa: F401
from .optim import clip_by_global_norm, make_scheduler, sgd_update  # noqa: F401
