"""Gradient clipping, torch-exact SGD, and learning-rate schedules.

Port of the SGD subset of ``heterofl_tpu/utils/optim.py``.  The round
engine runs the fused flat form (ops/fused_update.py); the per-tree
functions here are the reference chain it is held to.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float = 1.0
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``torch.nn.utils.clip_grad_norm_`` semantics over a dict, leaves summed
    in sorted-key order: ``g * min(1, max_norm / (||g|| + 1e-6))``."""
    names = sorted(grads)
    sq = [torch.sum(grads[k].to(torch.float32) ** 2) for k in names]
    total = torch.sqrt(torch.stack(sq).sum())
    scale = torch.minimum(total.new_full((), max_norm) / (total + 1e-6), total.new_ones(()))
    return {k: g * scale for k, g in grads.items()}, total


def sgd_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               bufs: Dict[str, torch.Tensor], lr, momentum: float, weight_decay: float):
    """torch SGD with momentum and weight decay applied to the gradient:
    ``buf = momentum * buf + g + wd * p``; ``p = p - lr * buf``."""
    new_b = {k: momentum * bufs[k] + grads[k] + weight_decay * params[k] for k in params}
    new_p = {k: params[k] - lr * new_b[k] for k in params}
    return new_p, new_b


def make_scheduler(cfg: Dict[str, Any]) -> Callable[[int], float]:
    """LR as a function of the (1-indexed) global round: ``None`` or
    ``MultiStepLR`` (the schedules the vision controls use)."""
    name = cfg["scheduler_name"]
    base = cfg["lr"]
    if name == "None":
        return lambda step: base
    if name == "MultiStepLR":
        factor = cfg.get("factor", 0.1)
        miles = sorted(cfg["milestones"])
        return lambda step: base * factor ** sum(1 for m in miles if step - 1 >= m)
    raise NotImplementedError(f"scheduler_name={name!r} is not ported to "
                              f"heterofl_tpu_torch yet (None, MultiStepLR are)")
