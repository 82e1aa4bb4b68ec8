"""Named metrics from weighted sums.

Port of ``summarize_sums`` of ``heterofl_tpu/utils/metrics.py`` and the
names of its metric registry: the round engine and the evaluator keep
``loss_sum`` / ``score_sum`` / ``n`` sums on the device; one fetch turns
them into the reference's named means with a ``Local-`` or ``Global-``
prefix: Loss, and Accuracy in percent for the vision models (``score_sum``
the weighted correct count) or Perplexity for the masked LM (``score_sum``
the row-weighted sum of per-window ``exp(CE)``: the reference's
size-weighted mean of batch perplexities).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: the metrics each model kind reports, before their ``Local-`` /
#: ``Global-`` prefix
METRICS = {"vision": ("Loss", "Accuracy"), "transformer": ("Loss", "Perplexity")}


def summarize_sums(sums: Dict[str, np.ndarray], prefix: str = "Local-", kind: str = "vision"
                   ) -> Dict[str, float]:
    """Sums -> ``{prefix + "Loss", prefix + "Accuracy" | "Perplexity"}``;
    empty when no sample was counted."""
    n = float(np.sum(sums["n"]))
    if n <= 0:
        return {}
    score = float(np.sum(sums["score_sum"])) / n
    return {prefix + "Loss": float(np.sum(sums["loss_sum"])) / n,
            prefix + METRICS[kind][1]: score * 100.0 if kind == "vision" else score}
