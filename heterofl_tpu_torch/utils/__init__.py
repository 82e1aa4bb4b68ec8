"""Checkpoints, the experiment logger, optimizers, schedules and metrics."""

from .checkpoint import (CheckpointCorruptError, checkpoint_path, copy_best,  # noqa: F401
                         load_checkpoint, load_newest_verifying, resume, save_checkpoint)
from .logger import Logger  # noqa: F401
from .metrics import summarize_sums  # noqa: F401
from .optim import (PlateauScheduler, clip_by_global_norm, make_optimizer,  # noqa: F401
                    make_scheduler, sgd_update)
