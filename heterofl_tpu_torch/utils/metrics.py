"""Named metrics from weighted sums.

Port of ``summarize_sums`` of ``heterofl_tpu/utils/metrics.py`` for the
vision models (the language-model branch, Perplexity, comes with the LM
path): the round engine and the evaluator keep ``loss_sum`` /
``score_sum`` / ``n`` sums on the device; one fetch turns them into the
reference's named means, Loss and Accuracy in percent, with a ``Local-`` or
``Global-`` prefix.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def summarize_sums(sums: Dict[str, np.ndarray], prefix: str = "Local-") -> Dict[str, float]:
    """Sums -> ``{prefix + "Loss", prefix + "Accuracy"}``; empty when no
    sample was counted."""
    n = float(np.sum(sums["n"]))
    if n <= 0:
        return {}
    return {prefix + "Loss": float(np.sum(sums["loss_sum"])) / n,
            prefix + "Accuracy": float(np.sum(sums["score_sum"])) / n * 100.0}
