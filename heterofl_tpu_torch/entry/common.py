"""Experiment loop of the federated vision entry point.

Port of the ``superstep_rounds=1`` training path of
``heterofl_tpu/entry/common.py``: CLI flags generated from the cfg keys
(common.py:75-111), then per seed :class:`FedExperiment` -- split the data,
stage every user's shard on the device once, and per round sample the
cohort, train it (:class:`~..parallel.RoundEngine`) and log the round's
train loss, accuracy and time.  Evaluation (sBN, Local/Global),
checkpoints and the logger are not ported yet.

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
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import config as C
from .. import resolve_device
from ..data import fetch_dataset, label_split_masks, split_dataset, stack_client_shards
from ..models import make_model
from ..parallel import RoundEngine
from ..utils import make_scheduler


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
        self.scheduler = make_scheduler(cfg)
        self.num_active = int(math.ceil(cfg["frac"] * cfg["num_users"]))
        if not 0 < self.num_active <= cfg["num_users"]:
            raise ValueError(f"frac={cfg['frac']} draws num_active={self.num_active} "
                             f"outside [1, num_users={cfg['num_users']}]")
        self.history: List[Dict[str, float]] = []

    def make_splits(self):
        return split_dataset(self.dataset, self.cfg["num_users"], self.cfg["data_split_mode"],
                             self.rng, classes_size=self.cfg["classes_size"])

    def stage(self, data_split, label_split) -> None:
        """Every user's train shard onto the device, once."""
        cfg, tr = self.cfg, self.dataset["train"]
        users = cfg["num_users"]
        x, y, m = stack_client_shards(tr.data, tr.target, data_split["train"], list(range(users)))
        lm = label_split_masks(label_split, users, cfg["classes_size"])
        self.train_data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                                for a in (x, y, m, lm))

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

    def run(self) -> Dict[str, Any]:
        data_split, label_split = self.make_splits()
        self.stage(data_split, label_split)
        P = self.engine.flatten(self.model.params())
        for epoch in range(1, self.cfg["num_epochs"]["global"] + 1):
            P = self.train_round(P, epoch, self.scheduler(epoch))
        return {"params": {k: v.clone() for k, v in self.engine.unflatten(P).items()},
                "history": self.history, "data_split": data_split,
                "label_split": label_split}


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
