"""Norm sites of the vision models.

Port of ``heterofl_tpu/models/norms.py``: ``bn`` (batch norm, momentum
None), ``in`` (GroupNorm(C, C), unmasked), ``ln`` (GroupNorm(1, C)) and
``gn`` (GroupNorm(4, C)) -- the last two with group boundaries that follow
the client's active channel count (``ops.layers.dynamic_group_norm``) --
and ``none``.  A BN site runs in one of ``ops.layers.batch_norm``'s modes:
``"batch"`` (the training forward), ``"running"`` (evaluation with sBN
statistics) or ``"collect"`` (the sBN pass).  ``pallas_norm=True`` routes
``"batch"`` through the CUDA kernels of ``ops/fused_norm.py`` (the
counterpart of the reference's Pallas route, which takes only that mode and
only ``bn``, norms.py:44-48); otherwise, in the other modes and for the
other norms, plain PyTorch runs, the counterpart of the XLA path (the
reference has no Pallas kernel for them).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.fused_norm import batch_norm_fused
from ..ops.layers import batch_norm, dynamic_group_norm, instance_norm

NORM_TYPES = ("bn", "in", "ln", "gn", "none")
#: groups of the masked group norms
NUM_GROUPS = {"ln": 1, "gn": 4}


def check_norm(norm_type: str) -> None:
    if norm_type not in NORM_TYPES:
        raise ValueError(f"Not valid norm: {norm_type!r} (control field 7, one of "
                         f"{NORM_TYPES})")


def norm_has_params(norm_type: str) -> bool:
    return norm_type != "none"


def apply_norm(norm_type: str, x: torch.Tensor, g: Optional[torch.Tensor],
               b: Optional[torch.Tensor], sample_weight: Optional[torch.Tensor] = None,
               use_fused: bool = False, bn_mode: str = "batch",
               bn_running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               group_ops: Optional[Tuple[torch.Tensor, int, torch.Tensor]] = None):
    """One norm site -> ``(y, collected (mean, var) or None)``.
    ``group_ops``: ``(mask [C], k, onehot [C, G])`` of the site's width
    group at the client's width (``FedModel.group_ops``), which ``ln`` and
    ``gn`` need."""
    check_norm(norm_type)
    if norm_type == "none":
        return x, None
    if norm_type == "bn":
        if use_fused and bn_mode == "batch":
            return batch_norm_fused(x, g, b, sample_weight=sample_weight), None
        return batch_norm(x, g, b, sample_weight=sample_weight, mode=bn_mode,
                          running=bn_running)
    if norm_type == "in":
        return instance_norm(x, g, b), None
    mask, k, onehot = group_ops
    return dynamic_group_norm(x, g, b, NUM_GROUPS[norm_type], mask, k, onehot=onehot), None
