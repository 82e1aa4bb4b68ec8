"""Gradient clipping, optimizers over parameter dicts, and learning-rate
schedules.

Port of ``heterofl_tpu/utils/optim.py``.  The centralised engine
(entry/central.py) updates per tree through :func:`make_optimizer`: SGD
exactly as torch (momentum and weight decay on the gradient, ``p -= lr *
buf``), RMSprop, Adam and Adamax as the reference writes them.  Its state is
a plain dict ``{"step": int, "slots": ...}`` whose slots are
parameter-shaped dicts of tensors.

The federated engines run the same optimizers in flat form
(:class:`FlatOptimizer`): the slots are flat float32 buffers (``[n]``, or a
grouped level's ``[G, ld]`` rows) and the step counter an int32 tensor on
the device (``[]`` or ``[G]``), so a captured step reads this replay's count,
never the count it was captured at.  Every op after the clip is
elementwise, and the flat and the per-leaf update run one function
(:func:`_update`), so a flat update equals :func:`make_optimizer`'s per-leaf
update bit for bit.  SGD's fused form is ops/fused_update.py's kernel;
:func:`sgd_update` and :func:`clip_by_global_norm` are the per-leaf chain it
is held to.

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
from typing import Any, Callable, Dict, Optional, Tuple

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


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


#: each optimizer's slots (the reference's ``OptState.slots``), and the
#: optimizers whose update reads the step counter (their bias correction)
SLOTS = {"SGD": ("buf",), "RMSprop": ("sq", "buf"), "Adam": ("m", "v"), "Adamax": ("m", "v")}
COUNTED = ("Adam", "Adamax")
RMS_ALPHA, RMS_EPS = 0.99, 1e-8
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _corrections(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam's bias corrections ``(1 - b1 ** t, 1 - b2 ** t)`` at the float32
    step count ``t``, each power a float32 power of the count as the
    reference's ``b ** t.astype(f32)``."""
    return (1 - torch.full_like(t, ADAM_B1) ** t, 1 - torch.full_like(t, ADAM_B2) ** t)


def _update(name: str, p: torch.Tensor, g: torch.Tensor, slots: Dict[str, torch.Tensor], lr,
            corr, momentum: float, wd: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One update of one tensor (a leaf, or flat buffers) -> ``(new p, new
    slots)``, in the reference's expression order (ref optim.py:37-101);
    ``corr`` the bias corrections of :func:`_corrections` (Adam, Adamax)."""
    if name == "SGD":
        buf = momentum * slots["buf"] + g + wd * p
        return p - lr * buf, {"buf": buf}
    g2 = g + wd * p  # torch: decay before the squares
    if name == "RMSprop":
        sq = RMS_ALPHA * slots["sq"] + (1 - RMS_ALPHA) * g2 * g2
        buf = momentum * slots["buf"] + g2 / (torch.sqrt(sq) + RMS_EPS)
        return p - lr * buf, {"sq": sq, "buf": buf}
    c1, c2 = corr
    m = ADAM_B1 * slots["m"] + (1 - ADAM_B1) * g2
    if name == "Adam":
        v = ADAM_B2 * slots["v"] + (1 - ADAM_B2) * g2 * g2
        denom = torch.sqrt(v / c2) + ADAM_EPS
    else:  # Adamax: the infinity norm
        v = torch.maximum(ADAM_B2 * slots["v"], torch.abs(g2) + ADAM_EPS)
        denom = v
    return p - lr * (m / c1) / denom, {"m": m, "v": v}


def sgd_update(params: Params, grads: Params, bufs: Params, lr, momentum: float,
               weight_decay: float) -> Tuple[Params, Params]:
    """torch SGD with momentum and weight decay applied to the gradient:
    ``buf = momentum * buf + g + wd * p``; ``p = p - lr * buf``."""
    new_p, new_b = {}, {}
    for k in params:
        new_p[k], out = _update("SGD", params[k], grads[k], {"buf": bufs[k]}, lr, None,
                                momentum, weight_decay)
        new_b[k] = out["buf"]
    return new_p, new_b


def make_optimizer(cfg: Dict[str, Any]):
    """``(init(params) -> state, update(params, grads, state, lr) ->
    (new_params, new_state))`` for ``cfg['optimizer_name']`` (SGD, RMSprop,
    Adam, Adamax; ref optim.py:37-101)."""
    name = cfg["optimizer_name"]
    if name not in SLOTS:
        raise ValueError("Not valid optimizer name")
    momentum = cfg.get("momentum", 0.0)
    wd = cfg.get("weight_decay", 0.0)

    def init(params):
        if name == "SGD":
            return {"step": 0, "slots": _zeros(params)}
        return {"step": 0, "slots": {s: _zeros(params) for s in SLOTS[name]}}

    def update(params, grads, state, lr):
        sl, t = state["slots"], state["step"] + 1
        if name == "SGD":
            new_p, bufs = sgd_update(params, grads, sl, lr, momentum, wd)
            return new_p, {"step": t, "slots": bufs}
        corr = None
        if name in COUNTED:
            like = next(iter(params.values()))
            corr = _corrections(torch.full((), float(t), dtype=torch.float32,
                                           device=like.device))
        new_p, new_s = {}, {s: {} for s in SLOTS[name]}
        for k in params:
            new_p[k], out = _update(name, params[k], grads[k], {s: sl[s][k] for s in SLOTS[name]},
                                    lr, corr, momentum, wd)
            for s in SLOTS[name]:
                new_s[s][k] = out[s]
        return new_p, {"step": t, "slots": new_s}

    return init, update


class FlatOptimizer:
    """``cfg['optimizer_name']`` over flat buffers, for the federated
    engines (ref round_engine.py:593-594, :627-633).

    A state is a dict of the optimizer's slots (:data:`SLOTS`), each a flat
    float32 buffer shaped like the params -- ``[n]`` a client, ``[G, ld]`` a
    grouped level's rows -- and, for Adam and Adamax (:data:`COUNTED`),
    ``"step"``: the int32 step counter on the device, ``[]`` or ``[G]``.  SGD
    and RMSprop carry no counter: their update never reads it (the
    reference's fused state drops it for SGD for the same reason)."""

    def __init__(self, cfg: Dict[str, Any]):
        self.name = cfg.get("optimizer_name", "SGD")
        if self.name not in SLOTS:
            raise ValueError("Not valid optimizer name")
        self.slots = SLOTS[self.name]
        self.momentum = float(cfg.get("momentum", 0.0))
        self.weight_decay = float(cfg.get("weight_decay", 0.0))

    def init(self, like: torch.Tensor, first: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """A fresh (zero) state for params shaped like ``like``; ``first``,
        a zero buffer shaped like it, becomes the first slot in place of a
        new one."""
        st = {s: torch.zeros_like(like) if i or first is None else first
              for i, s in enumerate(self.slots)}
        if self.name in COUNTED:
            st["step"] = torch.zeros(like.shape[:-1], dtype=torch.int32, device=like.device)
        return st

    @staticmethod
    def reset(state: Dict[str, torch.Tensor]) -> None:
        """Zero every slot and the counter in place: a client's fresh state."""
        for v in state.values():
            v.zero_()

    @staticmethod
    def rows(state: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
        """Views of a ``[G, ld]`` state's first ``n`` columns (the counter
        whole)."""
        return {k: v if k == "step" else v[:, :n] for k, v in state.items()}

    def update_(self, p: torch.Tensor, g: torch.Tensor, state: Dict[str, torch.Tensor], lr,
                has: torch.Tensor) -> None:
        """One step, in place on ``p`` and ``state``, from the clipped
        gradient ``g`` (shaped as ``p``): where ``has`` (bool, ``[]``, or
        ``[G]`` a row) is false the params, slots and counter keep their
        values -- an all-padding batch or a step past a deadline does not
        advance the counter (ref round_engine.py:628-633)."""
        corr = None
        if "step" in state:
            t = state["step"] + 1
            corr = _corrections(t.to(torch.float32).unsqueeze(-1))
        new_p, new_s = _update(self.name, p, g, {s: state[s] for s in self.slots}, lr, corr,
                               self.momentum, self.weight_decay)
        keep = has.reshape(tuple(has.shape) + (1,) * (p.dim() - has.dim()))
        p.copy_(torch.where(keep, new_p, p))
        for s in self.slots:
            state[s].copy_(torch.where(keep, new_s[s], state[s]))
        if "step" in state:
            state["step"].copy_(torch.where(has, t, state["step"]))


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
        eta_min = cfg["min_lr"]
        return lambda step: eta_min + (base - eta_min) * (1 + math.cos(math.pi * (step - 1) / tmax)) / 2
    if name == "CyclicLR":
        up = 2000  # torch's default step_size_up, triangular
        return lambda step: base + (10 * base - base) * _triangle((step - 1) / up)
    if name == "ReduceLROnPlateau":
        return PlateauScheduler(base, factor, cfg["patience"], cfg["threshold"],
                                cfg["min_lr"])
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
