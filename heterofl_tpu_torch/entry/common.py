"""Experiment loop of the federated vision entry point.

Port of the ``superstep_rounds=1`` path of ``heterofl_tpu/entry/common.py``:
CLI flags generated from the cfg keys (common.py:75-111), then per seed
:class:`FedExperiment` -- split the data, stage every user's train shard and
the evaluation operands on the device once, and per round sample the
cohort, train it (:class:`~..parallel.RoundEngine`) and log the round's
train loss, accuracy and time; every ``eval_interval`` rounds and after the
last, recalibrate BN (sBN) and evaluate Local and Global
(:class:`~..parallel.Evaluator`).  Checkpoints and the logger are not
ported yet.

The numpy stream ``self.rng = np.random.default_rng(seed)`` feeds the data
split first and then the per-round user permutation, as in the reference
experiment loop (common.py:229, 578, 682-684), so cohorts match the
reference's for the same seed under its ``sampler='perm'``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config as C
from .. import resolve_device
from ..data import fetch_dataset, label_split_masks, split_dataset, stack_client_shards
from ..models import make_model
from ..parallel import Evaluator, RoundEngine
from ..utils import make_scheduler, summarize_sums


def build_cli(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    for k, v in C.DEFAULT_CFG.items():
        if v is None or isinstance(v, (dict, list)):
            parser.add_argument(f"--{k}", default=None, type=str,
                                help=f"JSON override (default {json.dumps(v)})")
        elif isinstance(v, bool):
            parser.add_argument(f"--{k}", default=None, type=int)
        else:
            parser.add_argument(f"--{k}", default=None, type=type(v))
    parser.add_argument("--control_name", default=None, type=str)
    return parser


def cfg_from_args(args: argparse.Namespace) -> Dict[str, Any]:
    cfg = C.default_cfg()
    for k, v in C.DEFAULT_CFG.items():
        val = getattr(args, k, None)
        if val is None:
            continue
        if v is None:
            try:
                parsed = json.loads(val)
            except json.JSONDecodeError:
                parsed = val
            cfg[k] = parsed if isinstance(parsed, (dict, list, type(None))) else val
        elif isinstance(v, (dict, list)):
            cfg[k] = json.loads(val)
        elif isinstance(v, bool):
            cfg[k] = bool(val)
        else:
            cfg[k] = val
    if getattr(args, "control_name", None) and args.control_name != "None":
        cfg["control"] = C.parse_control_name(args.control_name)
    return cfg


def round_seed(seed: int, epoch: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(epoch)]).generate_state(1)[0])


def _batch_array(x: np.ndarray, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """``[N, ...]`` -> ``([S, b, ...], weights [S, b])``, the tail padded
    with zeros."""
    n = x.shape[0]
    s = math.ceil(n / b)
    pad = s * b - n
    w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x.reshape((s, b) + x.shape[1:]), w.reshape(s, b)


def stage_local_eval(xu: np.ndarray, yu: np.ndarray, mu: np.ndarray, batch_size: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-user test shards ``[U, N, ...]`` -> batched ``[U, S, B, ...]``,
    the tail padded with zero-weight samples."""
    u, n = xu.shape[0], xu.shape[1]
    b = min(batch_size, n)
    s = math.ceil(n / b)
    pad = s * b - n
    if pad:
        xu = np.concatenate([xu, np.zeros((u, pad) + xu.shape[2:], xu.dtype)], 1)
        yu = np.concatenate([yu, np.zeros((u, pad), yu.dtype)], 1)
        mu = np.concatenate([mu, np.zeros((u, pad), np.float32)], 1)
    return xu.reshape(u, s, b, *xu.shape[2:]), yu.reshape(u, s, b), mu.reshape(u, s, b)


def stage_eval_operands(cfg, train_set, test_set, test_split, lm):
    """The evaluation operands on the host: ``(sbn_batches (x, w),
    local_eval (x, y, m, lm), global_eval (x, y, w))``."""
    users = cfg["num_users"]
    sbn = _batch_array(train_set.data, cfg["batch_size"]["train"])
    b = cfg["batch_size"]["test"]
    xg, wg = _batch_array(test_set.data, b)
    yg, _ = _batch_array(test_set.target, b)
    xu, yu, mu = stack_client_shards(test_set.data, test_set.target, test_split,
                                     list(range(users)))
    local = stage_local_eval(xu, yu, mu, b) + (lm,)
    return sbn, local, (xg, yg, wg)


class FedExperiment:
    """One federated experiment (one seed)."""

    def __init__(self, cfg: Dict[str, Any], seed: int):
        C.check_ported(cfg)
        self.seed = seed
        self.device = resolve_device(cfg)
        self.rng = np.random.default_rng(seed)
        self.dataset = fetch_dataset(cfg["data_name"], cfg["data_dir"],
                                     synthetic=cfg["synthetic"], seed=seed,
                                     synthetic_sizes=cfg.get("synthetic_sizes"),
                                     subset=cfg.get("subset", "label"))
        cfg = dict(cfg)
        cfg["classes_size"] = self.dataset["train"].classes_size
        cfg["data_shape"] = list(self.dataset["train"].data.shape[1:])
        self.cfg = cfg
        self.tag = C.make_model_tag(seed, cfg)
        gen = torch.Generator().manual_seed(seed)
        self.model = make_model(cfg).init_(gen).to(self.device)
        self.engine = RoundEngine(self.model, cfg, self.device)
        self.evaluator = Evaluator(self.model, cfg, self.device)
        self.eval_interval = max(1, int(cfg.get("eval_interval", 1) or 1))
        self.scheduler = make_scheduler(cfg)
        self.num_active = int(math.ceil(cfg["frac"] * cfg["num_users"]))
        if not 0 < self.num_active <= cfg["num_users"]:
            raise ValueError(f"frac={cfg['frac']} draws num_active={self.num_active} "
                             f"outside [1, num_users={cfg['num_users']}]")
        self.history: List[Dict[str, float]] = []
        self.bn_state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}  # the last sBN pass's

    def make_splits(self):
        return split_dataset(self.dataset, self.cfg["num_users"], self.cfg["data_split_mode"],
                             self.rng, classes_size=self.cfg["classes_size"])

    def _to_device(self, arrays) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    def stage(self, data_split, label_split) -> None:
        """Every user's train shard and the evaluation operands onto the
        device, once."""
        cfg, tr = self.cfg, self.dataset["train"]
        users = cfg["num_users"]
        x, y, m = stack_client_shards(tr.data, tr.target, data_split["train"], list(range(users)))
        lm = label_split_masks(label_split, users, cfg["classes_size"])
        self.train_data = self._to_device((x, y, m, lm))
        sbn, local, glob = stage_eval_operands(cfg, tr, self.dataset["test"],
                                               data_split["test"], lm)
        self.sbn_batches = self._to_device(sbn)
        self.local_eval = self._to_device(local)
        self.global_eval = self._to_device(glob)

    def sample_users(self, epoch: int) -> np.ndarray:
        return self.rng.permutation(self.cfg["num_users"])[: self.num_active].astype(np.int64)

    def train_round(self, P: torch.Tensor, epoch: int, lr: float) -> torch.Tensor:
        user_idx = self.sample_users(epoch)
        t0 = time.time()
        P, ms = self.engine.train_round(P, lr, user_idx, self.train_data,
                                        round_seed(self.seed, epoch))
        sums = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in ms.items()}
        dt = time.time() - t0  # the fetch above waits for the round's last kernel
        n = float(sums["n"].sum())
        rec = {"epoch": epoch, "lr": lr, "seconds": dt, "n": n,
               "loss": float(sums["loss_sum"].sum()) / max(n, 1e-12),
               "accuracy": 100.0 * float(sums["score_sum"].sum()) / max(n, 1e-12),
               "rates": sorted(set(sums["rate"].tolist()))}
        self.history.append(rec)
        print(f"Model: {self.tag} Train Epoch: {epoch} Learning rate: {lr:g} "
              f"Loss: {rec['loss']:.4f} Accuracy: {rec['accuracy']:.4f} "
              f"Round time: {dt:.2f}s Rates: {rec['rates']}", flush=True)
        return P

    def evaluate(self, P: torch.Tensor, epoch: int) -> Dict[str, float]:
        """sBN, then Local, then Global, on the global flat params ``P``
        (ref entry/common.py:1241-1272) -> the named test metrics."""
        t0 = time.time()
        params = self.engine.unflatten(P)
        bn = self.evaluator.sbn_stats(params, *self.sbn_batches)
        local = self.evaluator.eval_users(params, bn, *self.local_eval)
        named = summarize_sums(local)
        g = self.evaluator.eval_global(params, bn, *self.global_eval)
        named.update(summarize_sums(g, prefix="Global-"))
        named["eval_seconds"] = time.time() - t0
        self.bn_state = bn
        print(f"Model: {self.tag} Test Epoch: {epoch} "
              + " ".join(f"{k}: {v:.4f}" for k, v in named.items()), flush=True)
        return named

    def run(self) -> Dict[str, Any]:
        data_split, label_split = self.make_splits()
        self.stage(data_split, label_split)
        P = self.engine.flatten(self.model.params())
        last = self.cfg["num_epochs"]["global"]
        for epoch in range(1, last + 1):
            P = self.train_round(P, epoch, self.scheduler(epoch))
            if epoch % self.eval_interval == 0 or epoch == last:
                self.history[-1].update(self.evaluate(P, epoch))
        return {"params": {k: v.clone() for k, v in self.engine.unflatten(P).items()},
                "history": self.history, "data_split": data_split,
                "label_split": label_split, "bn_state": self.bn_state,
                "wire_resid": self.engine.wire_resid_host()}


def run_main(description: str, model_default: str, data_default: str,
             argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Parse flags, loop the seeds, run the experiments."""
    args = build_cli(description).parse_args(argv)
    cfg = cfg_from_args(args)
    if args.model_name is None:
        cfg["model_name"] = model_default
    if args.data_name is None:
        cfg["data_name"] = data_default
    cfg = C.process_control(cfg)
    resolve_device(cfg)  # fail before any data is made
    results = []
    for i in range(cfg["num_experiments"]):
        exp = FedExperiment(cfg, cfg["init_seed"] + i)
        print(f"Experiment: {exp.tag}", flush=True)
        results.append(exp.run())
    return results
