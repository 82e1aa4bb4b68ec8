"""Centralised (non-federated) baselines, vision and masked LM.

Port of ``heterofl_tpu/entry/central.py`` (the reference's
``src/train_classifier.py`` and ``src/train_transformer.py``): the
global-rate model trained epoch by epoch on the whole train set with a
persistent optimizer, then sBN recalibration (vision) and the test every
epoch, a checkpoint every epoch and a copy of the best by test accuracy
(the LM: the minimised Perplexity).  The LM trains on the train stream's
bptt windows of 100 rows in order, without a shuffle, as the reference
does (central.py:142-162), with the same per-step update; its per-step
metrics are the window's ``CE * rows``, ``exp(CE) * rows`` and the rows.
The reference splits each batch over the devices of its mesh; here one GPU
takes the whole batch, so batch norm's batch statistics span all of it.  A
dataset without a ``DATASET_STATS`` entry is normalised with statistics
computed from its train split (``common._maybe_compute_norm_stats``).

One step (:meth:`CentralEngine.train_epoch`, ref central.py:51-79): the
forward in BN ``batch`` mode (through the CUDA kernels of
``ops/fused_norm.py`` when ``pallas_norm``), the weighted-mean loss times
the batch's weight ``n``, the backward, the gradients divided by ``n``,
``clip_by_global_norm(1.0)``, and the per-tree optimizer update of
``utils/optim.py::make_optimizer``.  The fused masked-SGD kernel is not on
this path: the reference updates per tree here too.

The checkpoint blob is the reference's (``cfg, epoch, params, bn_state,
pivot, logger_history, opt_state``) with params in the reference's layout,
but ``opt_state`` is the port's plain dict ``{"step": int, "slots": ...}``
(slots in the reference's layout) where the reference pickles its own
``OptState`` class: centralised checkpoints are not interchangeable between
the packages, federated ones are.  Resume restores params, epoch, pivot and
optimizer state, as the reference's does (not the logger); the epoch's
shuffle comes from ``self.rng``, which a resumed run restarts.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config as C
from .. import resolve_device
from ..convert import params_from_jax, params_to_jax
from ..data import bptt_windows, fetch_dataset, process_dataset, stack_windows
from ..fed.core import validate_width_geometry
from ..models import make_model
from ..models.base import FedModel
from ..ops.augment import augment_cifar
from ..parallel import Evaluator
from ..parallel.round_engine import norm_stats_tensors, prep_image
from ..utils import (Logger, clip_by_global_norm, make_optimizer, make_scheduler, resume,
                     summarize_sums)
from ..utils.metrics import METRICS
from .common import (_batch_array, _maybe_compute_norm_stats, parse_cfg, pivot_improves,
                     round_seed, write_checkpoint)

Params = Dict[str, torch.Tensor]


class CentralEngine:
    """The epoch of the centralised baseline on one device."""

    def __init__(self, model: FedModel, cfg: Dict[str, Any], device: torch.device):
        self.model, self.cfg, self.device = model, cfg, device
        self.is_lm = model.meta["kind"] == "transformer"
        if not self.is_lm:
            self.norm = norm_stats_tensors(cfg, device)
            self.augment = cfg["data_name"].startswith("CIFAR")
        self._opt_init, self._opt_update = make_optimizer(cfg)

    def init_opt(self, params: Params) -> Dict[str, Any]:
        return self._opt_init(params)

    def train_epoch(self, params: Params, opt: Dict[str, Any], lr: float, *data: torch.Tensor,
                    gen: Optional[torch.Generator] = None,
                    draws: Optional[Callable[[int], Dict[str, Any]]] = None
                    ) -> Tuple[Params, Dict[str, Any], torch.Tensor]:
        """One epoch over the batches ``data`` (device tensors): vision ``(x
        [S, B, H, W, C] uint8, y [S, B], sample weights w [S, B])``, CIFAR
        batches augmented with draws from ``gen``; LM ``(windows [S, B,
        bptt], position weights [S, B, bptt])``, the corruption and dropout
        drawn from ``gen`` (``draws(t)``, a test hook, gives step ``t``'s
        instead) -> ``(params, optimizer state, [loss_sum, correct_sum |
        perplexity_sum, n] on the device)``.  No value is read back per
        step."""
        names = sorted(params)
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=self.device)
        acc = torch.zeros(3, dtype=torch.float32, device=self.device)
        rows_n = torch.full((), float(data[0].shape[1]), dtype=torch.float32, device=self.device)
        for t in range(data[0].shape[0]):
            leaves = {k: params[k].detach().requires_grad_() for k in names}
            if self.is_lm:
                wb = data[1][t]
                _, loss = self.model(data[0][t], params=leaves, sample_weight=wb, train=True,
                                     gen=gen, draws=None if draws is None else draws(t))
            else:
                xb, yb, wb = data[0][t], data[1][t], data[2][t]
                if self.augment:
                    xb = augment_cifar(xb, gen)
                img = prep_image(xb, self.norm)
                score, loss = self.model(img, yb, params=leaves, sample_weight=wb)
            n = wb.sum()
            lsum = loss * n  # weighted-SUM form, as the reference
            grads = torch.autograd.grad(lsum, [leaves[k] for k in names])
            denom = n.clamp_min(1e-6)
            g, _ = clip_by_global_norm({k: gr / denom for k, gr in zip(names, grads)}, 1.0)
            params, opt = self._opt_update({k: leaves[k].detach() for k in names}, g, opt, lr_t)
            if self.is_lm:
                wl, rows = lsum.detach() / denom, rows_n * (n > 0).to(torch.float32)
                acc += torch.stack([wl * rows, torch.exp(wl) * rows, rows])
            else:
                correct = ((score.detach().argmax(-1) == yb).to(torch.float32) * wb).sum()
                acc += torch.stack([lsum.detach(), correct, n])
        return params, opt, acc


def _map_param_dicts(tree, fn: Callable):
    """``fn`` applied to every dict of parameter leaves (the innermost
    dicts) of an optimizer's slots."""
    if all(not isinstance(v, dict) for v in tree.values()):
        return fn(tree)
    return {k: _map_param_dicts(v, fn) for k, v in tree.items()}


class CentralExperiment:
    """The centralised baseline experiment (``data_split_mode='none'``)."""

    def __init__(self, cfg: Dict[str, Any], seed: int):
        C.check_ported(cfg)
        self.seed = seed
        self.device = resolve_device(cfg)
        self.rng = np.random.default_rng(seed)
        dataset = fetch_dataset(cfg["data_name"], cfg["data_dir"], synthetic=cfg["synthetic"],
                                seed=seed, synthetic_sizes=cfg.get("synthetic_sizes"),
                                subset=cfg.get("subset", "label"))
        self.cfg, self.dataset = process_dataset(cfg, dataset)
        cfg = self.cfg
        _maybe_compute_norm_stats(cfg, self.dataset)
        self.kind = "transformer" if cfg["model_name"] == "transformer" else "vision"
        self.tag = C.make_model_tag(seed, cfg)
        self.model = make_model(cfg).init_(torch.Generator().manual_seed(seed)).to(self.device)
        validate_width_geometry(self.model, cfg)
        self.perms = self.model.jax_perms()
        self.engine = CentralEngine(self.model, cfg, self.device)
        self.evaluator = Evaluator(self.model, cfg, self.device, seed=seed)
        self.scheduler = make_scheduler(cfg)
        self.checkpoint_keep = C.resolve_checkpoint_keep(cfg)
        self.history: List[Dict[str, Any]] = []  # one record per epoch this run trained
        tr, te = self.dataset["train"], self.dataset["test"]
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        if self.kind == "transformer":
            # on the device once: the train and test streams' bptt windows
            bptt = cfg["bptt"]
            self.train_windows = tuple(map(put, stack_windows(bptt_windows(tr.token, bptt), bptt)))
            self.global_eval = tuple(map(put, stack_windows(bptt_windows(te.token, bptt), bptt)))
            return
        # on the device once: the sBN batches over the train set (their rows
        # are also what each epoch's shuffle gathers from) and the test set
        self.sbn_batches = tuple(map(put, _batch_array(tr.data, cfg["batch_size"]["train"])))
        self.train_x = self.sbn_batches[0].reshape(-1, *tr.data.shape[1:])
        self.train_y = put(tr.target)
        b = cfg["batch_size"]["test"]
        xg, wg = _batch_array(te.data, b)
        yg, _ = _batch_array(te.target, b)
        self.global_eval = tuple(map(put, (xg, yg, wg)))

    def epoch_permutation(self, epoch: int) -> np.ndarray:
        """The epoch's shuffle of the train set (ref central.py:150)."""
        return self.rng.permutation(len(self.dataset["train"]))

    def epoch_batches(self, epoch: int) -> Tuple[torch.Tensor, ...]:
        """The shuffled train set as ``[S, B, ...]`` batches on the device,
        the tail padded with zero images of weight 0 (ref central.py:142-153);
        an LM's train windows, in order."""
        if self.kind == "transformer":
            return self.train_windows
        b = self.cfg["batch_size"]["train"]
        perm = torch.from_numpy(self.epoch_permutation(epoch)).to(self.device)
        n = perm.numel()
        s = math.ceil(n / b)
        idx = torch.cat([perm, perm.new_zeros(s * b - n)])
        x, y = self.train_x[idx], self.train_y[idx]
        w = torch.ones(s * b, dtype=torch.float32, device=self.device)
        x[n:], y[n:], w[n:] = 0, 0, 0.0
        return x.view(s, b, *x.shape[1:]), y.view(s, b), w.view(s, b)

    def evaluate(self, params: Params, epoch: int = 0
                 ) -> Tuple[Dict[str, Any], Dict[str, float]]:
        """sBN over the train set (vision), then the test set at ``epoch``
        (the LM's draws are seeded from it) -> ``(bn_state, sums)``."""
        bn = {} if self.kind == "transformer" else \
            self.evaluator.sbn_stats(params, *self.sbn_batches)
        return bn, self.evaluator.eval_global(params, bn, *self.global_eval, epoch=epoch)

    def _opt_to_blob(self, opt: Dict[str, Any]) -> Dict[str, Any]:
        to_jax = lambda d: params_to_jax(d, self.perms)  # noqa: E731
        return {"step": int(opt["step"]), "slots": _map_param_dicts(opt["slots"], to_jax)}

    def _opt_from_blob(self, st) -> Dict[str, Any]:
        if not isinstance(st, dict):
            raise ValueError(f"checkpointed opt_state is a {type(st).__name__}, not the port's "
                             f"{{'step', 'slots'}} dict: centralised checkpoints of the JAX "
                             f"package do not resume here")
        dev = lambda d: {k: v.to(self.device)  # noqa: E731
                         for k, v in params_from_jax(d, self.perms).items()}
        return {"step": int(st["step"]), "slots": _map_param_dicts(st["slots"], dev)}

    def run(self, pivot_metric: str = "Accuracy", pivot_mode: str = "max") -> Dict[str, Any]:
        cfg = self.cfg
        params = {k: v.detach().clone() for k, v in self.model.params().items()}
        opt = self.engine.init_opt(params)
        epoch0 = 1
        pivot = -math.inf if pivot_mode == "max" else math.inf
        logger = Logger(os.path.join(cfg["output_dir"], "runs", f"train_{self.tag}"),
                        use_tensorboard=bool(cfg.get("use_tensorboard")))
        blob = resume(cfg["output_dir"], self.tag, cfg["resume_mode"])
        if blob and "params" in blob:
            params = {k: v.to(self.device)
                      for k, v in params_from_jax(blob["params"], self.perms).items()}
            if "epoch" in blob:
                epoch0 = blob["epoch"]
                pivot = blob.get("pivot", pivot)
            if blob.get("opt_state") is not None:  # momentum survives a resume
                opt = self._opt_from_blob(blob["opt_state"])
        ne = cfg["num_epochs"]
        n_epochs = ne["global"] if isinstance(ne, dict) else ne
        bn: Dict[str, Any] = {}
        for epoch in range(epoch0, n_epochs + 1):
            logger.safe(True)
            lr = self.scheduler(epoch)
            t0 = time.time()
            gen = torch.Generator(device=self.device).manual_seed(round_seed(self.seed, epoch))
            params, opt, acc = self.engine.train_epoch(params, opt, lr, *self.epoch_batches(epoch),
                                                       gen=gen)
            lsum, csum, n = acc.tolist()  # waits for the epoch's last kernel
            dt = time.time() - t0
            named = summarize_sums({"loss_sum": lsum, "score_sum": csum, "n": n}, prefix="",
                                   kind=self.kind)
            logger.append(named, "train", n=n)
            logger.append({"info": [f"Model: {self.tag}", f"Train Epoch: {epoch}",
                                    f"Learning rate: {lr:g}", f"Epoch time: {dt:.2f}s"]},
                          "train", mean=False)
            logger.write("train", list(named))
            t0 = time.time()
            bn, g = self.evaluate(params, epoch)
            named_g = summarize_sums(g, prefix="", kind=self.kind)
            score = METRICS[self.kind][1]  # Accuracy | Perplexity
            rec = {"epoch": epoch, "lr": lr, "seconds": dt, "n": n, "loss": named.get("Loss"),
                   score.lower(): named.get(score), **named_g,
                   "eval_seconds": time.time() - t0}
            self.history.append(rec)
            logger.append(named_g, "test", n=g["n"])
            logger.append({"info": [f"Model: {self.tag}", f"Test Epoch: {epoch}",
                                    f"Eval time: {rec['eval_seconds']:.2f}s"]}, "test",
                          mean=False)
            logger.write("test", list(named_g))
            logger.safe(False)
            cur = logger.history.get(f"test/{pivot_metric}", [None])[-1]
            is_best = pivot_improves(cur, pivot, pivot_mode)
            if is_best:
                pivot = cur  # before saving, so a resumed run keeps it
            blob = lambda: {  # noqa: E731
                "cfg": {k: v for k, v in cfg.items() if k != "vocab"},
                "epoch": epoch + 1, "params": params_to_jax(params, self.perms), "bn_state": bn,
                "pivot": pivot, "logger_history": dict(logger.history),
                "opt_state": self._opt_to_blob(opt)}
            write_checkpoint(cfg["output_dir"], self.tag, blob, self.checkpoint_keep, is_best, rec)
            logger.reset()
        return {"params": params, "bn_state": bn, "logger": logger, "opt_state": opt,
                "history": self.history}


def run_central_main(description: str, model_default: str, data_default: str,
                     pivot_metric: str, pivot_mode: str, argv: Optional[List[str]] = None
                     ) -> List[Dict[str, Any]]:
    """Parse flags (the control's split forced to ``none``), loop the seeds,
    run the experiments."""
    cfg = parse_cfg(description, model_default, data_default, argv, data_split_mode="none")
    results = []
    for i in range(cfg["num_experiments"]):
        exp = CentralExperiment(cfg, cfg["init_seed"] + i)
        print(f"Experiment: {exp.tag}", flush=True)
        results.append(exp.run(pivot_metric, pivot_mode))
    return results
