"""Norm sites of the vision models.

Port of ``heterofl_tpu/models/norms.py`` for ``bn`` and ``none``.  A BN
site runs in one of ``ops.layers.batch_norm``'s modes: ``"batch"`` (the
training forward), ``"running"`` (evaluation with sBN statistics) or
``"collect"`` (the sBN pass).  ``pallas_norm=True`` routes ``"batch"``
through the CUDA kernels of ``ops/fused_norm.py`` (the counterpart of the
reference's Pallas route, which takes only that mode, norms.py:44-48);
otherwise, and in the other modes, the plain two-pass
``ops.layers.batch_norm`` runs, the counterpart of the XLA path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.fused_norm import batch_norm_fused
from ..ops.layers import batch_norm

PORTED_NORMS = ("bn", "none")


def check_norm(norm_type: str) -> None:
    if norm_type not in PORTED_NORMS:
        raise NotImplementedError(
            f"norm={norm_type!r} (control field 7) is not ported to heterofl_tpu_torch "
            f"yet (one of {PORTED_NORMS})")


def norm_has_params(norm_type: str) -> bool:
    return norm_type != "none"


def apply_norm(norm_type: str, x: torch.Tensor, g: Optional[torch.Tensor],
               b: Optional[torch.Tensor], sample_weight: Optional[torch.Tensor] = None,
               use_fused: bool = False, bn_mode: str = "batch",
               bn_running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One norm site -> ``(y, collected (mean, var) or None)``."""
    check_norm(norm_type)
    if norm_type == "none":
        return x, None
    if use_fused and bn_mode == "batch":
        return batch_norm_fused(x, g, b, sample_weight=sample_weight), None
    return batch_norm(x, g, b, sample_weight=sample_weight, mode=bn_mode, running=bn_running)
