"""Federation algebra: width rates and counted aggregation.

Port of the fix-mode subset of ``heterofl_tpu/fed/core.py``
(``to_width_rates``, ``combine_counted``, core.py:442-473).  The round
engine works in the flat domain (one buffer per tree,
ops/fused_update.FlatSpec), so the counted average takes flat buffers; the
count masks are built by the engine from ``models.spec.param_mask``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_width_rates(model_rates, cfg: Dict[str, Any]) -> np.ndarray:
    """Absolute model rate -> width/scaler rate relative to the global model
    (float32, as the reference computes it)."""
    return np.asarray(model_rates, np.float32) / np.float32(cfg["global_model_rate"])


def combine_counted(global_flat: torch.Tensor, summed: torch.Tensor,
                    counts: torch.Tensor) -> torch.Tensor:
    """Counted average with stale fallback: ``sum / count`` where some client
    held the entry, the previous global value elsewhere (ref fed.py:217-218)."""
    return torch.where(counts > 0, summed / counts.clamp_min(1.0), global_flat)
