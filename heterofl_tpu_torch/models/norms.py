"""Norm sites of the vision models.

Port of ``heterofl_tpu/models/norms.py`` for ``bn`` (batch statistics, the
training forward) and ``none``.  ``pallas_norm=True`` routes the train-time
BN through the CUDA kernels of ``ops/fused_norm.py`` (the counterpart of
the reference's Pallas route, norms.py:44-48); otherwise the plain
two-pass ``ops.layers.batch_norm`` runs, the counterpart of the XLA path.
"""

from __future__ import annotations

from typing import Optional

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
               use_fused: bool = False) -> torch.Tensor:
    check_norm(norm_type)
    if norm_type == "none":
        return x
    if use_fused:
        return batch_norm_fused(x, g, b, sample_weight=sample_weight)
    return batch_norm(x, g, b, sample_weight=sample_weight)
