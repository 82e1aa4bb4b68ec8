"""Gradient clipping, optimizers over parameter dicts, and learning-rate
schedules.

Port of ``heterofl_tpu/utils/optim.py``.  The federated round engine runs
SGD in the fused flat form (ops/fused_update.py); :func:`sgd_update` and
:func:`clip_by_global_norm` are the per-leaf chain it is held to.  The
centralised engine (entry/central.py) updates per tree through
:func:`make_optimizer`: SGD exactly as torch (momentum and weight decay on
the gradient, ``p -= lr * buf``), RMSprop, Adam and Adamax as the reference
writes them.  An optimizer's state is a plain dict ``{"step": int,
"slots": ...}`` whose slots are parameter-shaped dicts of tensors.

Schedules are functions ``round -> lr`` evaluated on the host once per
round (or epoch); ``ReduceLROnPlateau`` is the stateful
:class:`PlateauScheduler`, fed the test Global loss after each evaluation.
:func:`superstep_lrs` is the superstep's counterpart of the reference's
``make_traced_lr_fn``: a superstep's k learning rates staged as one float32
vector, from which each round's is copied into a static device scalar
before that round's graph replays.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def clip_by_global_norm(grads: Params, max_norm: float = 1.0) -> Tuple[Params, torch.Tensor]:
    """``torch.nn.utils.clip_grad_norm_`` semantics over a dict, leaves summed
    in sorted-key order: ``g * min(1, max_norm / (||g|| + 1e-6))``."""
    names = sorted(grads)
    sq = [torch.sum(grads[k].to(torch.float32) ** 2) for k in names]
    total = torch.sqrt(torch.stack(sq).sum())
    scale = torch.minimum(total.new_full((), max_norm) / (total + 1e-6), total.new_ones(()))
    return {k: g * scale for k, g in grads.items()}, total


def sgd_update(params: Params, grads: Params, bufs: Params, lr, momentum: float,
               weight_decay: float) -> Tuple[Params, Params]:
    """torch SGD with momentum and weight decay applied to the gradient:
    ``buf = momentum * buf + g + wd * p``; ``p = p - lr * buf``."""
    new_b = {k: momentum * bufs[k] + grads[k] + weight_decay * params[k] for k in params}
    new_p = {k: params[k] - lr * new_b[k] for k in params}
    return new_p, new_b


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _f32_pow(base: float, t: int, like: torch.Tensor) -> torch.Tensor:
    """``base ** t`` in float32, as the reference's ``b ** t.astype(f32)``."""
    return torch.tensor(base, dtype=torch.float32, device=like.device) ** float(t)


def make_optimizer(cfg: Dict[str, Any]):
    """``(init(params) -> state, update(params, grads, state, lr) ->
    (new_params, new_state))`` for ``cfg['optimizer_name']`` (SGD, RMSprop,
    Adam, Adamax; ref optim.py:37-101)."""
    name = cfg["optimizer_name"]
    momentum = cfg.get("momentum", 0.0)
    wd = cfg.get("weight_decay", 0.0)

    if name == "SGD":
        def init(params):
            return {"step": 0, "slots": _zeros(params)}

        def update(params, grads, state, lr):
            new_p, new_b = sgd_update(params, grads, state["slots"], lr, momentum, wd)
            return new_p, {"step": state["step"] + 1, "slots": new_b}

        return init, update

    if name == "RMSprop":
        alpha, eps = 0.99, 1e-8

        def init(params):
            return {"step": 0, "slots": {"sq": _zeros(params), "buf": _zeros(params)}}

        def update(params, grads, state, lr):
            sl = state["slots"]
            g2 = {k: grads[k] + wd * params[k] for k in params}  # decay before squaring
            sq = {k: alpha * sl["sq"][k] + (1 - alpha) * g2[k] * g2[k] for k in params}
            buf = {k: momentum * sl["buf"][k] + g2[k] / (torch.sqrt(sq[k]) + eps)
                   for k in params}
            new_p = {k: params[k] - lr * buf[k] for k in params}
            return new_p, {"step": state["step"] + 1, "slots": {"sq": sq, "buf": buf}}

        return init, update

    if name in ("Adam", "Adamax"):
        b1, b2, eps = 0.9, 0.999, 1e-8

        def init(params):
            return {"step": 0, "slots": {"m": _zeros(params), "v": _zeros(params)}}

        def update(params, grads, state, lr):
            sl, t = state["slots"], state["step"] + 1
            g2 = {k: grads[k] + wd * params[k] for k in params}
            m = {k: b1 * sl["m"][k] + (1 - b1) * g2[k] for k in params}
            like = next(iter(params.values()))
            if name == "Adam":
                v = {k: b2 * sl["v"][k] + (1 - b2) * g2[k] * g2[k] for k in params}
                c2 = 1 - _f32_pow(b2, t, like)
                denom = {k: torch.sqrt(v[k] / c2) + eps for k in params}
            else:  # Adamax: the infinity norm
                v = {k: torch.maximum(b2 * sl["v"][k], torch.abs(g2[k]) + eps) for k in params}
                denom = v
            c1 = 1 - _f32_pow(b1, t, like)
            new_p = {k: params[k] - lr * (m[k] / c1) / denom[k] for k in params}
            return new_p, {"step": t, "slots": {"m": m, "v": v}}

        return init, update

    raise ValueError("Not valid optimizer name")


def make_scheduler(cfg: Dict[str, Any]) -> Callable[[int], float]:
    """LR as a function of the (1-indexed) global round (ref
    optim.py:104-135): None, StepLR, MultiStepLR, ExponentialLR,
    CosineAnnealingLR, CyclicLR, or ReduceLROnPlateau (a
    :class:`PlateauScheduler`)."""
    name = cfg["scheduler_name"]
    base = cfg["lr"]
    factor = cfg.get("factor", 0.1)
    if name == "None":
        return lambda step: base
    if name == "StepLR":
        size = cfg["step_size"]
        return lambda step: base * factor ** ((step - 1) // size)
    if name == "MultiStepLR":
        miles = sorted(cfg["milestones"])
        return lambda step: base * factor ** sum(1 for m in miles if step - 1 >= m)
    if name == "ExponentialLR":
        return lambda step: base * 0.99 ** (step - 1)
    if name == "CosineAnnealingLR":
        ne = cfg["num_epochs"]
        tmax = ne["global"] if isinstance(ne, dict) else ne
        eta_min = cfg.get("min_lr", 0.0)
        return lambda step: eta_min + (base - eta_min) * (1 + math.cos(math.pi * (step - 1) / tmax)) / 2
    if name == "CyclicLR":
        up = 2000  # torch's default step_size_up, triangular
        return lambda step: base + (10 * base - base) * _triangle((step - 1) / up)
    if name == "ReduceLROnPlateau":
        return PlateauScheduler(base, factor, cfg.get("patience", 10),
                                cfg.get("threshold", 1e-3), cfg.get("min_lr", 0.0))
    raise ValueError("Not valid scheduler name")


def superstep_lrs(scheduler: Callable[[int], float], epoch0: int, k: int) -> np.ndarray:
    """The learning rates (float32 ``[k]``) of rounds ``epoch0 .. epoch0 + k
    - 1`` (ref utils/optim.py:138-175, ``make_traced_lr_fn``): each round's
    ``scheduler(round)`` rounded to float32 as the K=1 round rounds it;
    ReduceLROnPlateau holds its rate for the whole superstep (it steps only
    on evaluations at superstep boundaries, ``config.resolve_superstep_cfg``)."""
    if isinstance(scheduler, PlateauScheduler):
        return np.full(k, scheduler(epoch0), np.float32)
    return np.asarray([scheduler(epoch0 + r) for r in range(k)], np.float32)


def _triangle(x: float) -> float:
    cycle = math.floor(1 + x / 2)
    return max(0.0, 1 - abs(x - 2 * cycle + 1))


class PlateauScheduler:
    """min-mode ReduceLROnPlateau with a relative threshold (torch's)."""

    def __init__(self, base: float, factor: float, patience: int, threshold: float,
                 min_lr: float):
        self.lr = base
        self.factor, self.patience, self.threshold, self.min_lr = factor, patience, threshold, min_lr
        self.best = float("inf")
        self.bad = 0

    def __call__(self, step: int) -> float:
        return self.lr

    def step_metric(self, metric: float) -> None:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0

    def state_dict(self) -> Dict[str, float]:
        """The mutable state, for a checkpoint: a resumed run keeps its
        plateau counters."""
        return {"lr": self.lr, "best": self.best, "bad": self.bad}

    def load_state_dict(self, state: Dict[str, float]) -> None:
        self.lr = float(state["lr"])
        self.best = float(state["best"])
        self.bad = int(state["bad"])
