"""Experiment loop of the federated entry points (vision and masked LM).

Port of the ``superstep_rounds=1`` path of ``heterofl_tpu/entry/common.py``:
CLI flags generated from the cfg keys (common.py:75-111), then per seed
:class:`FedExperiment.run` (common.py:1276-1349, 1501-1600):

* the dataset (computed normalisation statistics for one without a
  ``DATASET_STATS`` entry, :func:`_maybe_compute_norm_stats`), the model
  and its width-geometry check (``fed.core.validate_width_geometry``);
* :func:`~..utils.resume` first; a blob's data and label split replace the
  split draw, and its params, error-feedback residual, epoch, best pivot,
  logger state and scheduler state are restored;
* every user's train shard and the evaluation operands go onto the device
  once (a masked LM: each user's batchified token rows, and the test
  stream's bptt windows, common.py:622-629);
* per round: sample the cohort, train it (the engine of ``cfg['strategy']``,
  as common.py:711-723: :class:`~..parallel.RoundEngine` for ``masked``,
  :class:`~..parallel.GroupedRoundEngine` for ``grouped``,
  :class:`~..fed.sliced.SlicedFederation` for ``sliced``; each in
  ``dynamic`` mode draws the cohort's rates from the round seed alone, so a
  resumed run draws what an uninterrupted one drew; a cohort of 0 clients
  leaves the params as they are) and log the round; every
  ``eval_interval`` rounds and after the last, recalibrate BN (sBN) and
  evaluate Local and Global
  (:class:`~..parallel.Evaluator`; a masked LM: Global only, no sBN,
  common.py:1257-1259); then the best-pivot decision, a durable checkpoint
  in ``output_dir/model/`` and, on a new best, its copy to ``_best.pkl``.

The numpy stream ``self.rng = np.random.default_rng(seed)`` feeds the data
split first and then the per-round user permutation, as in the reference
experiment loop (common.py:229, 578, 682-684), so cohorts match the
reference's for the same seed under its ``sampler='perm'``.  A resumed run
skips the split draw, so its stream restarts without it -- as the
reference's does; there is no checkpoint of the stream.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import config as C
from .. import resolve_device
from ..convert import flat_from_jax, flat_to_jax, params_from_jax, params_to_jax
from ..data import (bptt_windows, fetch_dataset, label_split_masks, process_dataset,
                    split_dataset, stack_client_shards, stack_client_token_rows, stack_windows)
from ..data.datasets import DATASET_STATS
from ..data.stats import dataset_stats
from ..fed.core import validate_width_geometry
from ..models import make_model
from ..fed.sliced import SlicedFederation
from ..parallel import Evaluator, GroupedRoundEngine, RoundEngine
from ..utils import (Logger, PlateauScheduler, checkpoint_path, copy_best, make_scheduler,
                     resume, save_checkpoint, summarize_sums)
from ..utils.metrics import METRICS


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


def _maybe_compute_norm_stats(cfg: Dict[str, Any], dataset: Dict[str, Any]) -> None:
    """A vision dataset without a ``DATASET_STATS`` entry (EMNIST) gets
    per-channel statistics computed from its train split, cached under
    ``data_dir/stats``, into ``cfg['norm_stats']`` (ref
    entry/common.py:200-212)."""
    if cfg.get("norm_stats") or cfg["data_name"] in DATASET_STATS:
        return
    if not hasattr(dataset["train"], "data"):
        return
    mean, std = dataset_stats(cfg["data_name"], dataset["train"].data, cfg["data_dir"])
    cfg["norm_stats"] = (tuple(float(x) for x in mean), tuple(float(x) for x in std))


def pivot_improves(cur: Optional[float], pivot: float, pivot_mode: str) -> bool:
    """Whether the logged pivot metric ``cur`` (None when the iteration did
    not evaluate) beats the best so far."""
    return cur is not None and (cur > pivot if pivot_mode == "max" else cur < pivot)


def write_checkpoint(output_dir: str, tag: str, make_blob: Callable[[], Dict[str, Any]],
                     keep: int, is_best: bool, rec: Dict[str, Any]) -> None:
    """Durably write ``make_blob()`` as the live checkpoint (``keep``
    generations) and, when ``is_best``, copy it to ``_best.pkl``; the
    write's seconds (the blob's host copy included) and megabytes and the
    copy's seconds go into the round's (epoch's) record ``rec``."""
    t0 = time.time()
    path = checkpoint_path(output_dir, tag)
    save_checkpoint(path, make_blob(), keep=keep)
    rec["checkpoint_seconds"] = time.time() - t0
    rec["checkpoint_mb"] = os.path.getsize(path) / 1e6
    rec["best_seconds"] = None
    if is_best:
        t0 = time.time()
        copy_best(output_dir, tag)
        rec["best_seconds"] = time.time() - t0
    best = "" if rec["best_seconds"] is None else f", best copy {rec['best_seconds']:.3f}s"
    print(f"Model: {tag}  Checkpoint Epoch: {rec['epoch']}  {rec['checkpoint_mb']:.1f} MB "
          f"in {rec['checkpoint_seconds']:.3f}s{best}", flush=True)


class FedExperiment:
    """One federated experiment (one seed): data staging, engine,
    evaluator, logger and the checkpoint loop."""

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
        gen = torch.Generator().manual_seed(seed)
        self.model = make_model(cfg).init_(gen).to(self.device)
        validate_width_geometry(self.model, cfg)
        self.perms = self.model.jax_perms()
        engine = {"masked": RoundEngine, "grouped": GroupedRoundEngine,
                  "sliced": SlicedFederation}[C.resolve_strategy_cfg(cfg)]
        self.engine = engine(self.model, cfg, self.device)
        self.evaluator = Evaluator(self.model, cfg, self.device, seed=seed)
        self.eval_interval = max(1, int(cfg.get("eval_interval", 1) or 1))
        self.checkpoint_keep = C.resolve_checkpoint_keep(cfg)
        self.scheduler = make_scheduler(cfg)
        self.num_active = int(math.ceil(cfg["frac"] * cfg["num_users"]))
        if not 0 <= self.num_active <= cfg["num_users"]:
            raise ValueError(f"frac={cfg['frac']} draws num_active={self.num_active} "
                             f"outside [0, num_users={cfg['num_users']}]")
        # the training log (opens its files only inside a run's rounds)
        self.logger = Logger(os.path.join(cfg["output_dir"], "runs", f"train_{self.tag}"),
                             use_tensorboard=bool(cfg.get("use_tensorboard")))
        self.history: List[Dict[str, Any]] = []  # one record per round this run trained
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
        if self.kind == "transformer":
            rows = stack_client_token_rows(tr.token, data_split["train"], list(range(users)))
            lm = label_split_masks(label_split, users, cfg["num_tokens"])
            self.train_data = self._to_device((rows, lm))
            te = self.dataset["test"]
            self.global_eval = self._to_device(stack_windows(bptt_windows(te.token, cfg["bptt"]),
                                                             cfg["bptt"]))
            return
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
        """One round from the global flat params ``P``: the cohort, then
        local training and aggregation, the engine drawing the cohort's
        rates in ``dynamic`` mode as the reference's masked engine does
        (ref entry/common.py:700-712).  Its train loss and accuracy (a
        masked LM: perplexity) go to the experiment's logger as
        ``train/Local-*`` (ref entry/common.py:1189-1225), and the record
        with the cohort (``users``) and its rates (``user_rates``) to
        :attr:`history`."""
        user_idx = self.sample_users(epoch)
        t0 = time.time()
        P, ms = self.engine.train_round(P, lr, user_idx, self.train_data,
                                        round_seed(self.seed, epoch))
        sums = {k: v.cpu().numpy() if torch.is_tensor(v) else v for k, v in ms.items()}
        dt = time.time() - t0  # the fetch above waits for the round's last kernel
        n = float(sums["n"].sum())
        named = summarize_sums(sums, kind=self.kind)
        rec = {"epoch": epoch, "lr": lr, "seconds": dt, "n": n,
               "loss": named.get("Local-Loss", 0.0),
               "rates": sorted(set(sums["rate"][sums["n"] > 0].tolist())),
               "users": user_idx.tolist(), "user_rates": sums["rate"].tolist()}
        score = METRICS[self.kind][1]  # Accuracy | Perplexity
        rec[score.lower()] = named.get(f"Local-{score}", 0.0)
        self.history.append(rec)
        self.logger.append(named, "train", n=n)
        self.logger.append({"info": [f"Model: {self.tag}", f"Train Epoch: {epoch}",
                                     f"Learning rate: {lr:g}", f"Rates: {rec['rates']}",
                                     f"Round time: {dt:.2f}s"]}, "train", mean=False)
        self.logger.write("train", list(named))
        return P

    def evaluate(self, P: torch.Tensor, epoch: int,
                 logger: Optional[Logger] = None) -> Dict[str, float]:
        """sBN, then Local, then Global, on the global flat params ``P``
        (ref entry/common.py:1241-1272), logged under ``test/`` -> the named
        test metrics and ``eval_seconds``.  A masked LM runs Global only,
        its draws seeded from ``epoch``."""
        logger = self.logger if logger is None else logger
        t0 = time.time()
        params = self.engine.unflatten(P)
        bn, named = {}, {}
        if self.kind == "vision":
            bn = self.evaluator.sbn_stats(params, *self.sbn_batches)
            local = self.evaluator.eval_users(params, bn, *self.local_eval)
            named = summarize_sums(local)
            logger.append(named, "test", n=float(np.sum(local["n"])))
        g = self.evaluator.eval_global(params, bn, *self.global_eval, epoch=epoch)
        named_global = summarize_sums(g, prefix="Global-", kind=self.kind)
        logger.append(named_global, "test", n=g["n"])
        named.update(named_global)
        named["eval_seconds"] = time.time() - t0
        self.bn_state = bn
        logger.append({"info": [f"Model: {self.tag}", f"Test Epoch: {epoch}",
                                f"Eval time: {named['eval_seconds']:.2f}s"]}, "test", mean=False)
        logger.write("test", [k.split("/", 1)[1] for k in logger.mean if k.startswith("test/")])
        return named

    # -- the error-feedback residual in a blob: the reference's [clients,
    # slots, total] carry in its flat layout, one participant here
    def _resid_to_blob(self) -> Optional[np.ndarray]:
        resid = self.engine.wire_resid_host()
        return None if resid is None else \
            flat_to_jax(resid, self.engine.spec.shapes, self.perms)[None]

    def _resid_from_blob(self, arr) -> np.ndarray:
        arr = np.asarray(arr, np.float32)
        if arr.ndim != 3 or arr.shape[0] != 1:
            raise ValueError(f"checkpointed wire residual of shape {arr.shape}: the port runs "
                             f"one participant and restores a [1, slots, total] carry")
        return flat_from_jax(arr[0], self.engine.spec.shapes, self.perms)

    def run(self, pivot_metric: str = "Global-Accuracy", pivot_mode: str = "max"
            ) -> Dict[str, Any]:
        """Resume (per ``resume_mode``), then train to ``num_epochs.global``
        with a checkpoint every round and a copy of the best by
        ``test/{pivot_metric}``."""
        cfg, logger = self.cfg, self.logger
        blob = resume(cfg["output_dir"], self.tag, cfg["resume_mode"])
        if blob and blob.get("data_split") is not None:
            data_split, label_split = blob["data_split"], blob["label_split"]
        else:
            data_split, label_split = self.make_splits()
        self.stage(data_split, label_split)
        P = self.engine.flatten(self.model.params())
        epoch = 1
        pivot = -math.inf if pivot_mode == "max" else math.inf
        if blob:
            P = self.engine.flatten(params_from_jax(blob["params"], self.perms))
            if blob.get("wire_resid") is not None and self.engine.codec is not None:
                self.engine.set_wire_resid(self._resid_from_blob(blob["wire_resid"]))
            if "epoch" in blob:
                epoch = blob["epoch"]
                pivot = blob.get("pivot", pivot)
                logger.load_state_dict(blob.get("logger_state")
                                       or {"history": blob.get("logger_history", {})})
                if blob.get("scheduler_state") and hasattr(self.scheduler, "load_state_dict"):
                    self.scheduler.load_state_dict(blob["scheduler_state"])
        last = cfg["num_epochs"]["global"]
        if epoch <= last:
            # a restored logger state is the checkpointed round's, taken
            # before its reset: the next round's running means start from
            # zero, as in a run that was never interrupted (the reference's
            # first resumed round averages its means with that round's)
            logger.reset()
        while epoch <= last:
            P, pivot = self._run_iteration(P, epoch, last, pivot_metric, pivot_mode, pivot,
                                           data_split, label_split)
            epoch += 1
        return {"params": {k: v.clone() for k, v in self.engine.unflatten(P).items()},
                "history": self.history, "logger": logger, "data_split": data_split,
                "label_split": label_split, "bn_state": self.bn_state,
                "wire_resid": self.engine.wire_resid_host()}

    def _run_iteration(self, P, epoch, last, pivot_metric, pivot_mode, pivot, data_split,
                       label_split):
        """One round, its evaluation when due, the best-pivot decision and
        the durable checkpoint (ref entry/common.py:1501-1600) -> ``(P,
        pivot)``.  The checkpoint's seconds and bytes (the host copy of the
        params included) go into the round's :attr:`history` record."""
        cfg, logger = self.cfg, self.logger
        logger.safe(True)
        P = self.train_round(P, epoch, self.scheduler(epoch))
        if epoch % self.eval_interval == 0 or epoch == last:
            self.history[-1].update(self.evaluate(P, epoch))
            if isinstance(self.scheduler, PlateauScheduler):
                # min-mode plateau on the test Global loss, on evaluated rounds
                self.scheduler.step_metric(logger.mean.get("test/Global-Loss", 0.0))
        logger.safe(False)
        cur = logger.history.get(f"test/{pivot_metric}", [None])[-1]
        is_best = pivot_improves(cur, pivot, pivot_mode)
        if is_best:
            pivot = cur  # before saving, so a resumed run keeps it
        blob = lambda: {  # noqa: E731
            "cfg": {k: v for k, v in cfg.items() if k != "vocab"},
            "epoch": epoch + 1,
            "data_split": data_split,
            "label_split": label_split,
            "params": params_to_jax(self.engine.unflatten(P), self.perms),
            "bn_state": self.bn_state,
            "wire_resid": self._resid_to_blob(),
            "sched_buf": None,  # buffered-async aggregation: not ported
            "ledger": None,     # population ledger: not ported
            "pivot": pivot,
            "logger_history": dict(logger.history),
            "logger_state": logger.state_dict(),
            "scheduler_state": self.scheduler.state_dict()
            if hasattr(self.scheduler, "state_dict") else None,
        }
        write_checkpoint(cfg["output_dir"], self.tag, blob, self.checkpoint_keep, is_best,
                         self.history[-1])
        logger.reset()
        return P, pivot


def run_main(description: str, model_default: str, data_default: str,
             pivot_metric: str = "Global-Accuracy", pivot_mode: str = "max",
             argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Parse flags, loop the seeds, run the experiments."""
    cfg = parse_cfg(description, model_default, data_default, argv)
    results = []
    for i in range(cfg["num_experiments"]):
        exp = FedExperiment(cfg, cfg["init_seed"] + i)
        print(f"Experiment: {exp.tag}", flush=True)
        results.append(exp.run(pivot_metric, pivot_mode))
    return results


def parse_cfg(description: str, model_default: str, data_default: str,
              argv: Optional[List[str]] = None, data_split_mode: Optional[str] = None
              ) -> Dict[str, Any]:
    """The processed cfg of an entry point's flags (``data_split_mode``
    forces the control's split, as the centralised entry does), checked
    for its device before any data is made."""
    args = build_cli(description).parse_args(argv)
    cfg = cfg_from_args(args)
    if args.model_name is None:
        cfg["model_name"] = model_default
    if args.data_name is None:
        cfg["data_name"] = data_default
    if data_split_mode is not None:
        cfg["control"]["data_split_mode"] = data_split_mode
    cfg = C.process_control(cfg)
    resolve_device(cfg)
    return cfg
