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
reference's for the same seed under its ``sampler='perm'``.  A resumed K=1
run skips the split draw, so its stream restarts without it -- as the
reference's does.  ``sampler='prp'`` draws each round's cohort from the
round seed alone (``fed.core.round_users``).

``superstep_rounds`` K > 1 (:meth:`FedExperiment.train_superstep`, ref
common.py:941-1024 and the superstep branch of :meth:`_run_iteration`,
:1501-1540): K rounds a dispatch through the engine's ``train_superstep``
(each client's local steps replayed from CUDA graphs), its cohorts and
rates the next K draws of the K=1 stream, the evaluations that fall inside
it fused into it (``Evaluator.fused``), its metrics fetched once through
the :class:`~..parallel.staging.MetricsPipeline` and logged round by round
as the K=1 loop logs them; the checkpoint lands on the superstep boundary
and holds the permutation stream's state, so a resumed superstep run draws
what the uninterrupted one drew; the end of the run clamps the last
superstep to the rounds left.  ``superstep_rounds=1`` is the eager loop
above, its train metrics deferred ``metrics_fetch_every`` rounds (flushed
before each evaluation and at the end).

A ``schedule`` (``sched/``) filters each round's cohort by its availability
row (``-1`` for a slot no available user fills), at K=1 and in the
superstep's schedule; each round's record counts its slots ``filled`` and
``failed``; buffered aggregation's staleness buffer goes into the
checkpoint under ``sched_buf`` in the reference's flat layout and is
restored on resume (ref common.py:1308-1312, 1464-1465, 1572-1573).

``client_store='stream'`` (ref common.py:588-672, 783-935, 970-987, 1138-1144,
1516-1523): no ``[U, ...]`` stack is built; the population is a
:class:`~..parallel.staging.ClientStore` over the raw arrays, every
iteration is a superstep (a K=1 run's of one round), and each superstep's
cohort is gathered and copied onto the device (the engine's
``stage_cohort``) -- the first synchronously, the next ``stream_prefetch_depth``
right after a superstep is dispatched, while it runs.  The evaluation
operands are staged at the first evaluation; with ``eval_cohort`` the
Local evaluation runs on a rolling window of users, padded to the
population's largest test shard and copied into the same device operands
each window.  Under ``perm`` a prefetched cohort is drawn from the numpy
stream before the superstep in flight is checkpointed, so the checkpoint
records the stream's state from before the first prefetched draw (the
boundary), and a resumed streamed run, K=1 included, draws what the
uninterrupted run drew.  ``sample_horizon`` gates the draws on fetched
supersteps (:class:`~..fed.sampling.ScheduleCommitment`).

Observability and its guards (ref common.py:458-557, 1033-1131, 1276-1475):
each fetched round's probe record (``telemetry``, ``quarantine``) is
logged as an ``obs`` event and checked by the
:class:`~..obs.watchdog.Watchdog` (:meth:`FedExperiment._observe`); the
client ledger folds each fetch (:meth:`FedExperiment._fold_ledger`), rides
the checkpoint and is written to ``ledger.npz`` on every exit; a
``trace_dir`` run records its phases (:class:`~..parallel.staging.PhaseTimer`),
spans and events in a :class:`~..obs.trace.TraceRecorder`;
``profile_dir`` profiles the first steady dispatch; under
``watchdog={'action': 'rollback'}`` a trip restores the newest finite
checkpoint generation with salted seed streams
(:meth:`FedExperiment._recover_rollback`), up to ``max_retries`` times
before it aborts.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import warnings
from contextlib import nullcontext
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
from ..fed.core import (round_seed, round_users, superstep_rate_schedule,  # noqa: F401
                        superstep_user_schedule, validate_width_geometry)
from ..fed.sampling import ScheduleCommitment, resolve_sampler_cfg
from ..models import make_model
from ..sched import resolve_schedule_cfg
from ..fed.sliced import SlicedFederation
from ..parallel import Evaluator, GroupedRoundEngine, RoundEngine
from ..obs import obs_levels, resolve_ledger_cfg, resolve_quarantine_cfg, \
    resolve_telemetry_cfg, split_probes
from ..obs.ledger import ClientLedger
from ..obs.trace import TraceRecorder
from ..obs.watchdog import RETRY_SALT, Watchdog, WatchdogError, WatchdogRollback
from ..parallel.staging import ClientStore, MetricsPipeline, PendingMetrics, PhaseTimer
from ..utils import (Logger, PlateauScheduler, checkpoint_path, copy_best, make_scheduler,
                     resume, save_checkpoint, summarize_sums)
from ..utils.checkpoint import iter_verified_generations
from ..utils.metrics import METRICS
from ..utils.optim import superstep_lrs


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
            keep = isinstance(parsed, (dict, list, type(None))) or (
                isinstance(parsed, int) and not isinstance(parsed, bool))  # eval_cohort 3
            cfg[k] = parsed if keep else val
        elif isinstance(v, (dict, list)):
            cfg[k] = json.loads(val)
        elif isinstance(v, bool):
            cfg[k] = bool(val)
        elif isinstance(v, str) and val.lstrip().startswith("{"):
            cfg[k] = json.loads(val)  # a per-level map, e.g. --wire_codec '{"1": "int8"}'
        else:
            cfg[k] = val
    if getattr(args, "control_name", None) and args.control_name != "None":
        cfg["control"] = C.parse_control_name(args.control_name)
    return cfg


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


def salt_seed(seed: int, salt: int) -> int:
    """A seed stream's root mixed with ``salt`` (the rollback's retry salt):
    a deterministic function of both."""
    return int(np.random.SeedSequence([int(seed), int(salt)]).generate_state(1)[0])


def tree_finite(tree) -> bool:
    """Whether every float array or tensor leaf of a nested dict/list tree
    is all-finite (other leaves pass)."""
    if isinstance(tree, dict):
        return all(tree_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(tree_finite(v) for v in tree)
    if torch.is_tensor(tree):
        return not tree.is_floating_point() or bool(torch.isfinite(tree).all())
    if isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype, np.floating):
        return bool(np.isfinite(tree).all())
    return True


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
        self.sampler_spec = resolve_sampler_cfg(cfg)
        self.sampler = self.sampler_spec.kind
        # the streaming store (its refusals raise in process_control, as in
        # the reference): the store, the queue of prefetched (epoch0, k,
        # cohort, the perm stream's state before its draw), the commitment
        self.streaming = C.resolve_store_cfg(cfg) == "stream"
        self.stream_prefetch = cfg.get("stream_prefetch", True)
        self._prefetch_depth = C.resolve_prefetch_depth(cfg)
        self.eval_cohort = C.resolve_eval_cohort(cfg)
        self.store: Optional[ClientStore] = None
        self._next_cohorts: List[Tuple[int, int, Any, Any]] = []
        self._stream_sync_warned = False
        self._eval_widx: Optional[int] = None  # the rolling Local-eval window staged
        self._commitment = None
        self._ss_dispatched = self._ss_fetched = 0
        self.superstep_rounds, fetch_every = C.resolve_superstep_cfg(
            cfg, isinstance(self.scheduler, PlateauScheduler))
        self.metrics_pipe = MetricsPipeline(fetch_every)
        # the schedule's cross-field refusals (a scenario with sliced, buffered
        # with a lossy codec or with grouped at K=1) raise here, as in the
        # reference, before its experiment loop's own copies of them could
        self.sched = resolve_schedule_cfg(cfg)
        if self.superstep_rounds == 1 and fetch_every > self.eval_interval:
            # evaluate() drains the pipeline, so batches never grow past it
            warnings.warn(
                f"metrics_fetch_every={fetch_every} exceeds "
                f"eval_interval={self.eval_interval}: each eval boundary flushes the metric "
                f"pipeline, so the effective fetch batch is eval_interval rounds")
        self._fused = None  # the superstep's evaluation, made at its first use
        self._checkpoint_recs: Dict[int, Dict[str, Any]] = {}  # of rounds not yet logged
        self.num_active = int(math.ceil(cfg["frac"] * cfg["num_users"]))
        if not 0 <= self.num_active <= cfg["num_users"]:
            raise ValueError(f"frac={cfg['frac']} draws num_active={self.num_active} "
                             f"outside [0, num_users={cfg['num_users']}]")
        # the training log (opens its files only inside a run's rounds)
        self.logger = Logger(os.path.join(cfg["output_dir"], "runs", f"train_{self.tag}"),
                             use_tensorboard=bool(cfg.get("use_tensorboard")))
        self.history: List[Dict[str, Any]] = []  # one record per round this run trained
        self.bn_state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}  # the last sBN pass's
        # observability and its guards (obs/, chaos/; their refusals raise in
        # process_control, as in the reference): the probes' watchdog, the
        # run trace (made in run()), the client ledger, the host phases
        self.obs_spec = resolve_telemetry_cfg(cfg)
        self.quarantine = resolve_quarantine_cfg(cfg)
        self.obs_levels = obs_levels(cfg)
        self._observing = self.obs_spec.probes or self.quarantine.enabled
        self._poisoned = cfg.get("chaos_poison") is not None
        self.watchdog = Watchdog(self.obs_spec.watchdog) \
            if self.obs_spec.probes and self.obs_spec.watchdog is not None else None
        self.ledger = ClientLedger(cfg["num_users"], self.obs_levels) \
            if resolve_ledger_cfg(cfg).enabled else None
        self.tracer: Optional[TraceRecorder] = None
        self.phase_timer = PhaseTimer()
        # the root of the round-seed stream (cohorts under prp, rates,
        # clients' draws): the seed, salted by each rollback
        self.stream_seed = seed
        self._rollback_attempts = 0  # since the last clean checkpoint
        self._first_done = self._profiled = False  # profile_dir: the first steady dispatch
        self.profile_path: Optional[str] = None

    @property
    def _supersteps(self) -> bool:
        """Whether each iteration is a superstep: ``superstep_rounds`` > 1,
        or the stream store."""
        return self.superstep_rounds > 1 or self.streaming

    def make_splits(self):
        return split_dataset(self.dataset, self.cfg["num_users"], self.cfg["data_split_mode"],
                             self.rng, classes_size=self.cfg["classes_size"])

    def _to_device(self, arrays) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    def stage(self, data_split, label_split) -> None:
        """Every user's train shard and the evaluation operands onto the
        device, once; with the stream store only the population's index
        (the evaluation operands wait for the first evaluation,
        :meth:`_ensure_eval_staged`)."""
        cfg, tr = self.cfg, self.dataset["train"]
        users = cfg["num_users"]
        if self.streaming:
            if self.kind == "transformer":
                self.store = ClientStore.from_split(tr.token, None, data_split["train"],
                                                    label_split, cfg["num_tokens"], kind="lm")
            else:
                self.store = ClientStore.from_split(tr.data, tr.target, data_split["train"],
                                                    label_split, cfg["classes_size"])
            self.train_data = None
            self._eval_split = (data_split["test"], label_split)
            self._eval_staged = False
            return
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

    def _ensure_eval_staged(self) -> None:
        """The stream store's evaluation operands onto the device, at the
        first evaluation (ref common.py:631-672): sBN and Global always;
        Local for every user, or with ``eval_cohort`` per window
        (:meth:`_local_cohort_operands`)."""
        if self._eval_staged:
            return
        cfg, tr = self.cfg, self.dataset["train"]
        users = cfg["num_users"]
        test_split, label_split = self._eval_split
        if self.kind == "transformer":
            te = self.dataset["test"]
            self.global_eval = self._to_device(stack_windows(bptt_windows(te.token, cfg["bptt"]),
                                                             cfg["bptt"]))
        elif self.eval_cohort is not None:
            b = cfg["batch_size"]["test"]
            te = self.dataset["test"]
            xg, wg = _batch_array(te.data, b)
            yg, _ = _batch_array(te.target, b)
            self.sbn_batches = self._to_device(_batch_array(tr.data, cfg["batch_size"]["train"]))
            self.global_eval = self._to_device((xg, yg, wg))
            self.local_eval = None  # staged a window at a time
        else:
            if users > 100_000:
                warnings.warn(
                    f"local eval stages every user's test shard (O(U) at "
                    f"num_users={users}); set eval_cohort for a rolling "
                    f"O(cohort) Local eval, cap eval_interval past "
                    f"num_epochs, or stick to population benches if this "
                    f"OOMs")
            lm = label_split_masks(label_split, users, cfg["classes_size"])
            sbn, local, glob = stage_eval_operands(cfg, tr, self.dataset["test"], test_split, lm)
            self.sbn_batches = self._to_device(sbn)
            self.local_eval = self._to_device(local)
            self.global_eval = self._to_device(glob)
        self._eval_staged = True

    def _eval_cohort_users(self, widx: int) -> List[int]:
        """The rolling Local-eval window ``widx`` (ref common.py:875-883):
        ``eval_cohort`` consecutive users from ``widx * eval_cohort``,
        modulo the population -- deterministic in the window index (itself
        from the evaluation's epoch), so a resumed run evaluates the same
        window."""
        n, u = self.eval_cohort, self.cfg["num_users"]
        return [int(x) for x in (widx * n + np.arange(n)) % u]

    def _local_cohort_operands(self, widx: int):
        """The window's Local operands on the host (ref common.py:885-911),
        in ``stage_local_eval``'s batched layout, each shard padded to the
        population's largest test shard so every window has one shape."""
        users = self._eval_cohort_users(widx)
        test_split, label_split = self._eval_split
        if not hasattr(self, "_eval_shard_max"):
            self._eval_shard_max = max(len(test_split[u]) for u in range(self.cfg["num_users"]))
        te = self.dataset["test"]
        xu, yu, mu = stack_client_shards(te.data, te.target, test_split, users)
        n = self._eval_shard_max
        if xu.shape[1] < n:
            pad = n - xu.shape[1]
            xu = np.concatenate([xu, np.zeros((len(users), pad) + xu.shape[2:], xu.dtype)], 1)
            yu = np.concatenate([yu, np.zeros((len(users), pad), yu.dtype)], 1)
            mu = np.concatenate([mu, np.zeros((len(users), pad), np.float32)], 1)
        lm = label_split_masks({i: label_split[u] for i, u in enumerate(users)}, len(users),
                               self.cfg["classes_size"])
        b = min(self.cfg["batch_size"]["test"], n)
        return stage_local_eval(xu, yu, mu, b) + (lm,)

    # -- the streamed cohorts ------------------------------------------------

    def _stage_cohort(self, epoch0: int, k: int):
        """Draw and stage the cohort of rounds ``epoch0 .. epoch0 + k - 1``
        -> ``(epoch0, k, cohort, the perm stream's state before the draw)``."""
        cfg = self.cfg
        state = self.rng.bit_generator.state if self.sampler == "perm" else None
        with self.phase_timer.phase("sample"):
            users = superstep_user_schedule(self.stream_seed, epoch0, k, cfg["num_users"],
                                            self.num_active, self.sampler, self.rng, self.sched)
            rates = superstep_rate_schedule(self.stream_seed, epoch0, k, cfg, users)
        with self.phase_timer.phase("stage"):
            cohort = self.engine.stage_cohort(self.store, users, rates)
        return epoch0, k, cohort, state

    def _take_cohort(self, epoch0: int, k: int):
        """The prefetched cohort of this superstep, or one staged now (the
        run's first superstep; ``stream_prefetch`` off, warned once), with
        the commitment's checks (ref common.py:795-844).  The prefetch
        clamps its supersteps as the run loop does, so the queue always
        starts here."""
        if self._next_cohorts:
            if self._next_cohorts[0][:2] != (epoch0, k):
                raise RuntimeError(f"prefetched supersteps {[e[:2] for e in self._next_cohorts]}"
                                   f" do not start at (epoch {epoch0}, k {k})")
            return self._next_cohorts.pop(0)[2]
        horizon = self.sampler_spec.horizon
        if self._commitment is not None \
                and not self._commitment.may_draw(self._ss_dispatched + 1):
            raise RuntimeError(
                f"schedule commitment: the superstep at epoch {epoch0} "
                f"draws from superstep "
                f"{self._ss_dispatched - horizon}'s "
                f"state but only {self._ss_fetched} superstep(s) have "
                f"fetched -- a deferred metrics fetch crossed "
                f"sample_horizon={horizon}")
        if self._commitment is not None and horizon == 0 \
                and self._ss_dispatched > 0 and self.stream_prefetch \
                and not self._stream_sync_warned:
            self._stream_sync_warned = True
            warnings.warn(
                "sample_horizon=0 (strictly output-dependent sampler) is "
                "staging SYNCHRONOUSLY: each cohort draws from the "
                "previous superstep's just-fetched state, so staging "
                "cannot overlap compute -- sample_horizon=1 commits one "
                "state further back and keeps the overlap")
        if not self.stream_prefetch and not self._stream_sync_warned:
            self._stream_sync_warned = True
            warnings.warn(
                "client_store='stream' is staging SYNCHRONOUSLY "
                "(stream_prefetch=False): cohort materialisation serialises "
                "with the round compute instead of overlapping it -- an "
                "output-dependent sampler can keep the overlap by "
                "committing its schedule instead (cfg['sample_horizon'])")
        return self._stage_cohort(epoch0, k)[2]

    def _prefetch_cohort(self, epoch0: int) -> None:
        """Stage the next supersteps' cohorts, up to ``stream_prefetch_depth``
        ahead, right after a superstep is dispatched, so their gathers and
        copies overlap it (ref common.py:846-870); the commitment stops the
        queue where a draw would read state not yet fetched."""
        if not self.stream_prefetch:
            return
        last = self.cfg["num_epochs"]["global"]
        e = self._next_cohorts[-1][0] + self._next_cohorts[-1][1] if self._next_cohorts \
            else epoch0
        while len(self._next_cohorts) < self._prefetch_depth and e <= last:
            if self._commitment is not None and not self._commitment.may_draw(
                    self._ss_dispatched + len(self._next_cohorts) + 1):
                break
            k = min(self.superstep_rounds, last - e + 1)
            self._next_cohorts.append(self._stage_cohort(e, k))
            e += k

    def _sampler_state(self):
        """The permutation stream's state at the superstep boundary: before
        the first prefetched cohort's draw, if one is queued."""
        if self._next_cohorts and self._next_cohorts[0][3] is not None:
            return self._next_cohorts[0][3]
        return self.rng.bit_generator.state

    def sample_users(self, epoch: int) -> np.ndarray:
        """The K=1 round's cohort: the next permutation of the numpy stream
        (``perm``) or the round seed's PRP image (``prp``), filtered by the
        schedule's availability row of the round (``-1``: a slot no
        available user fills)."""
        return round_users(round_seed(self.stream_seed, epoch), self.cfg["num_users"],
                           self.num_active, self.sampler, self.rng,
                           self.sched.avail_row(epoch))

    def train_round(self, P: torch.Tensor, epoch: int, lr: float) -> torch.Tensor:
        """One round from the global flat params ``P``: the cohort, then
        local training and aggregation, the engine drawing the cohort's
        rates in ``dynamic`` mode as the reference's masked engine does
        (ref entry/common.py:700-712).  Its metric sums (and ``obs_*``
        rows) go through the metrics pipeline (fetched now at
        ``metrics_fetch_every`` 1) and are logged when fetched
        (:meth:`_log_k1`)."""
        with self.phase_timer.phase("sample"):
            user_idx = self.sample_users(epoch)
        t0 = time.time()
        prof = self._profile_start()
        with self.phase_timer.phase("dispatch"):
            P, ms = self.engine.train_round(P, lr, user_idx, self.train_data,
                                            round_seed(self.stream_seed, epoch),
                                            **self._epoch_kw(epoch))
        self._profile_stop(prof)
        host = {k: v for k, v in ms.items() if not torch.is_tensor(v)}
        pending = PendingMetrics({k: v for k, v in ms.items() if torch.is_tensor(v)},
                                 lambda fetched, host=host: dict(fetched, **host))
        tag = {"epoch": epoch, "lr": lr, "users": user_idx, "t0": t0}
        with self.phase_timer.phase("fetch"):
            due = self.metrics_pipe.push(tag, pending)  # the fetch waits for the last kernel
        for tag, sums in due:
            self._log_k1(tag, sums)
        return P

    def _epoch_kw(self, epoch: int) -> Dict[str, int]:
        """The engine's ``epoch=`` (the poison's round), given only with a
        poison table: the sliced twin takes none."""
        return {"epoch": epoch} if self._poisoned else {}

    def _drain_metrics(self) -> None:
        """Log every round whose metrics the pipeline still holds."""
        with self.phase_timer.phase("fetch"):
            due = self.metrics_pipe.flush()
        for tag, out in due:
            if "k" in tag:
                self._log_superstep(tag, out)
            else:
                self._log_k1(tag, out)

    def _log_k1(self, tag: Dict[str, Any], sums) -> None:
        """A fetched K=1 round: its probe record split off (``obs_*`` rows;
        a gated slot's row and rate read 0), the ledger folded, the round
        logged (:meth:`_log_round`)."""
        probes = None
        if self._observing:
            sums, probes = split_probes(sums, self.obs_levels)
        if self.ledger is not None:
            self._fold_ledger(tag["epoch"], 1, [sums], np.asarray(tag["users"])[None])
        self._log_round(tag["epoch"], tag["lr"], time.time() - tag["t0"], tag["users"], sums,
                        probes)

    def _log_round(self, epoch: int, lr: float, dt: float, user_idx, sums,
                   probes: Optional[Dict[str, Any]] = None) -> None:
        """Log one round's fetched sums: its train loss and accuracy (a
        masked LM: perplexity) to the experiment's logger as
        ``train/Local-*`` (ref entry/common.py:1189-1225), and the record
        with the cohort (``users``), its rates (``user_rates``, 0 for a
        slot that did not train) and its slots (``filled``: not ``-1``;
        ``failed``: filled but not trained) to :attr:`history`; then, with
        ``probes`` (the round's record), :meth:`_observe`."""
        user_idx = np.asarray(user_idx, np.int64)
        n = float(sums["n"].sum())
        named = summarize_sums(sums, kind=self.kind)
        filled = user_idx >= 0
        rec = {"epoch": epoch, "lr": lr, "seconds": dt, "n": n,
               "loss": named.get("Local-Loss", 0.0),
               "rates": sorted(set(sums["rate"][sums["n"] > 0].tolist())),
               "users": user_idx.tolist(), "user_rates": sums["rate"].tolist(),
               "filled": int(filled.sum()),
               "failed": int((filled & (np.asarray(sums["rate"]) == 0)).sum())}
        score = METRICS[self.kind][1]  # Accuracy | Perplexity
        rec[score.lower()] = named.get(f"Local-{score}", 0.0)
        rec.update(self._checkpoint_recs.pop(epoch, {}))
        self.history.append(rec)
        self.logger.append(named, "train", n=n)
        self.logger.append({"info": [f"Model: {self.tag}", f"Train Epoch: {epoch}",
                                     f"Learning rate: {lr:g}", f"Rates: {rec['rates']}",
                                     f"Slots: {rec['filled']} of {user_idx.size} filled, "
                                     f"{rec['failed']} failed",
                                     f"Round time: {dt:.2f}s"]}, "train", mean=False)
        self.logger.write("train", list(named))
        if probes is not None:
            rec["probes"] = probes
            self._observe(epoch, probes, sums)

    # -- observability: probes, watchdog, ledger, trace, profile ---------------

    def _trace_span(self, name: str, args: Optional[Dict[str, Any]] = None):
        """A run-trace span, or nothing when the run is not traced."""
        if self.tracer is not None:
            return self.tracer.span(name, cat="driver", args=args)
        return nullcontext()

    def _persist_evidence(self, close: bool) -> None:
        """The trip's evidence on disk before a watchdog exception unwinds:
        the trace (closed on an abort, synced on a rollback), the log
        flushed, the ledger snapshot written."""
        if self.tracer is not None:
            if close:
                self.tracer.close()
            else:
                self.tracer.sync()
        self.logger.flush()
        if self.ledger is not None:
            self.ledger.save(self._ledger_path())

    def _observe(self, epoch: int, probes: Dict[str, Any], ms) -> None:
        """Surface one fetched round's probe record (ref entry/common.py:
        1033-1087): a ``probes`` event on the run's log and trace, then the
        watchdog (warning, abort, or rollback); a trip is on the log and
        the trace before its exception unwinds."""
        loss = None
        n = float(np.sum(ms["n"]))
        if n > 0:
            loss = float(np.sum(ms["loss_sum"])) / n
        self.logger.emit({"event": "probes", "epoch": int(epoch), "loss": loss, **probes})
        if self.tracer is not None:
            self.tracer.instant("probes", cat="obs",
                                args={"epoch": int(epoch), "loss": loss, **probes})
        if self.watchdog is None:
            return

        def emit_trip(ev):
            self.logger.emit(ev)
            if self.tracer is not None:
                self.tracer.instant("watchdog", cat="obs", args=ev)

        try:
            self.watchdog.check(epoch, probes=probes, loss=loss, emit=emit_trip)
        except WatchdogRollback:
            self._persist_evidence(close=False)  # the run goes on tracing
            raise
        except WatchdogError:
            self._persist_evidence(close=True)
            raise

    def _fold_ledger(self, epoch0: int, k: int, rounds, uid_rows) -> None:
        """Fold one fetch's rounds into the :class:`~..obs.ledger.ClientLedger`
        (round ``epoch0 + r``'s metric rows, aligned to its cohort
        ``uid_rows[r]``) and emit the ``ledger`` summary -- O(active) (ref
        entry/common.py:1089-1124)."""
        tot_active = tot_new = 0
        last = None
        for r in range(k):
            u = np.asarray(uid_rows[r])
            a, ms = len(u), rounds[r]
            last = self.ledger.update(epoch0 + r, u, np.asarray(ms["rate"])[:a],
                                      np.asarray(ms["loss_sum"])[:a], np.asarray(ms["n"])[:a])
            tot_active += last["active"]
            tot_new += last["new_users"]
        rec = {"event": "ledger", "epoch0": int(epoch0), "k": int(k), "active": tot_active,
               "new_users": tot_new, "coverage": last["coverage"],
               "loss_ema_mean": last["loss_ema_mean"], "bytes": self.ledger.nbytes}
        self.logger.emit(rec, tag="ledger")
        if self.tracer is not None:
            self.tracer.instant("ledger", cat="obs", args=rec)

    def _ledger_path(self) -> str:
        """``ledger.npz``: beside the trace when tracing, else under
        ``output_dir/obs/<tag>``."""
        base = os.path.join(self.obs_spec.trace_dir, self.tag) if self.obs_spec.trace_dir \
            else os.path.join(self.cfg["output_dir"], "obs", self.tag)
        return os.path.join(base, "ledger.npz")

    def _profile_start(self):
        """With ``profile_dir``, a ``torch.profiler`` trace (the card's
        activity on a GPU) of the first steady dispatch -- the second round
        or superstep a run trains, past the captures of the first (ref
        entry/common.py:706-712) -> the running profiler or None."""
        if not self.cfg.get("profile_dir") or not self._first_done or self._profiled:
            return None
        from torch.profiler import ProfilerActivity, profile

        self._profiled = True
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _profile_stop(self, prof) -> None:
        """End the dispatch's profile (the device synchronised first) and
        export its Chrome trace into ``profile_dir``."""
        self._first_done = True
        if prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg["profile_dir"], exist_ok=True)
        self.profile_path = os.path.join(self.cfg["profile_dir"], f"{self.tag}.pt.trace.json")
        prof.export_chrome_trace(self.profile_path)

    def evaluate(self, P: torch.Tensor, epoch: int,
                 logger: Optional[Logger] = None) -> Dict[str, float]:
        """sBN, then Local, then Global, on the global flat params ``P``
        (ref entry/common.py:1241-1272), logged under ``test/`` -> the named
        test metrics and ``eval_seconds``.  A masked LM runs Global only,
        its draws seeded from ``epoch``.  Rounds whose metrics the pipeline
        still holds are logged first.  With the stream store the operands
        are staged here if no evaluation staged them yet, and with
        ``eval_cohort`` Local runs on the window of ``epoch`` (the test
        entries evaluate a checkpoint this way)."""
        self._drain_metrics()
        logger = self.logger if logger is None else logger
        t0 = time.time()
        params = self.engine.unflatten(P)
        bn, named = {}, {}
        if self.streaming:
            self._ensure_eval_staged()
        if self.kind == "vision":
            bn = self.evaluator.sbn_stats(params, *self.sbn_batches)
            local_eval = self.local_eval if self.eval_cohort is None else self._to_device(
                self._local_cohort_operands(epoch // self.eval_interval))
            local = self.evaluator.eval_users(params, bn, *local_eval)
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

    # -- the superstep ---------------------------------------------------------

    def _fused_eval(self, widx: Optional[int] = None):
        """The superstep's evaluation over the staged operands (made once);
        with ``eval_cohort``, window ``widx``'s Local operands copied into
        it when the window moves (ref common.py:913-935)."""
        if self.streaming:
            self._ensure_eval_staged()
        if self.eval_cohort is not None and widx != self._eval_widx:
            local = self._local_cohort_operands(widx)
            if self._fused is None:
                self._fused = self.evaluator.fused(self.engine.spec, self.sbn_batches,
                                                   self._to_device(local), self.global_eval)
            else:
                self._fused.set_local(local)
            self._eval_widx = widx
        if self._fused is None:
            spec = self.engine.spec
            if self.kind == "vision":
                self._fused = self.evaluator.fused(spec, self.sbn_batches, self.local_eval,
                                                   self.global_eval)
            else:
                self._fused = self.evaluator.fused(spec, global_eval=self.global_eval)
        return self._fused

    def train_superstep(self, P: torch.Tensor, epoch0: int, k: int) -> torch.Tensor:
        """Rounds ``epoch0 .. epoch0 + k - 1`` as one dispatch (ref
        entry/common.py:941-1024): the ``[k, A]`` cohorts and rates of the
        K=1 stream, the k learning rates, the eval mask (a round evaluates
        when ``eval_interval`` divides it, and the run's last), then the
        engine's ``train_superstep``; its metrics go through the pipeline
        and are logged round by round when fetched (:meth:`_log_superstep`)."""
        cfg = self.cfg
        last = cfg["num_epochs"]["global"]
        lrs = superstep_lrs(self.scheduler, epoch0, k)
        mask = [(epoch0 + r) % self.eval_interval == 0 or epoch0 + r == last for r in range(k)]
        widx = None
        if any(mask) and self.eval_cohort is not None:
            # the window of the superstep's first evaluation
            widx = min(epoch0 + r for r in range(k) if mask[r]) // self.eval_interval
        fused = self._fused_eval(widx) if any(mask) else None
        t0 = time.time()
        seed = self.stream_seed
        if self.streaming:
            cohort = self._take_cohort(epoch0, k)
            users = cohort.users
            prof = self._profile_start()
            with self.phase_timer.phase("dispatch"):
                P, pending = self.engine.train_superstep(
                    P, seed, epoch0, k, None, users, cohort.rates, lrs,
                    mask if fused else None, fused, cohort=cohort)
            self._profile_stop(prof)
            self._ss_dispatched += 1
            with self._trace_span("prefetch", {"epoch0": int(epoch0 + k)}):
                self._prefetch_cohort(epoch0 + k)  # while this superstep runs
        else:
            with self.phase_timer.phase("sample"):
                users = superstep_user_schedule(seed, epoch0, k, cfg["num_users"],
                                                self.num_active, self.sampler, self.rng,
                                                self.sched)
                rates = superstep_rate_schedule(seed, epoch0, k, cfg, users)
            prof = self._profile_start()
            with self.phase_timer.phase("dispatch"):
                P, pending = self.engine.train_superstep(P, seed, epoch0, k, self.train_data,
                                                         users, rates, lrs,
                                                         mask if fused else None, fused)
            self._profile_stop(prof)
        tag = {"epoch0": epoch0, "k": k, "users": users, "lrs": lrs, "t0": t0,
               "pending": pending}
        with self.phase_timer.phase("fetch"):
            due = self.metrics_pipe.push(tag, pending)
        for tag, out in due:
            self._log_superstep(tag, out)
        return P

    def _log_superstep(self, tag: Dict[str, Any], out) -> None:
        """Log a fetched superstep as the K=1 loop logs its rounds (ref
        entry/common.py:1134-1188): each round's train metrics, its fused
        evaluation after it, the Plateau feed; every round but the last is
        closed into the logger's history and reset as a K=1 iteration
        closes its round, so the log equals a K=1 run's.  A round's
        ``seconds`` (and ``eval_seconds``) are the device's, between marks
        recorded on its stream around the round (and the evaluation).  Under
        ``sample_horizon`` the fetched superstep is committed: cohorts that
        read its state may be drawn now (ref common.py:1138-1144).  With the
        ledger the superstep's rounds are folded first, in one summary; each
        round's probe record goes to :meth:`_observe` after its log."""
        if self._commitment is not None:
            self._ss_fetched += 1
            self._commitment.commit(self._ss_fetched, state=out)
        rounds = out["train"] if isinstance(out, dict) else out
        evals = {e["epoch"]: e for e in out.get("eval", [])} if isinstance(out, dict) else {}
        probes = out.get("obs") if isinstance(out, dict) else None
        if self.ledger is not None:
            self._fold_ledger(tag["epoch0"], tag["k"], rounds, tag["users"])
        secs = tag["pending"].seconds
        logger, j = self.logger, 0
        for r in range(tag["k"]):
            epoch = tag["epoch0"] + r
            if r:
                for name in logger.mean:  # close the previous round, as safe(False) does
                    logger.history[name].append(logger.mean[name])
                logger.reset()
            self._log_round(epoch, float(tag["lrs"][r]), secs["train"][r], tag["users"][r],
                            rounds[r], probes[r] if probes else None)
            ev = evals.get(epoch)
            if ev is not None:
                self.history[-1].update(self._log_fused_eval(epoch, ev, secs["eval"][j]))
                j += 1
                if isinstance(self.scheduler, PlateauScheduler):
                    self.scheduler.step_metric(logger.mean.get("test/Global-Loss", 0.0))

    def _log_fused_eval(self, epoch: int, ev: Dict[str, Any], seconds: float
                        ) -> Dict[str, float]:
        """Log one fused evaluation as :meth:`evaluate` logs its own."""
        logger, named = self.logger, {}
        if self.kind == "vision" and ev["local"]:
            local = ev["local"]
            named = summarize_sums(local)
            logger.append(named, "test", n=float(np.sum(local["n"])))
        g = ev["global"]
        named_global = summarize_sums(g, prefix="Global-", kind=self.kind)
        logger.append(named_global, "test", n=g["n"])
        named.update(named_global)
        named["eval_seconds"] = seconds
        self.bn_state = ev["bn"]
        logger.append({"info": [f"Model: {self.tag}", f"Test Epoch: {epoch}",
                                f"Eval time: {seconds:.2f}s"]}, "test", mean=False)
        logger.write("test", [k.split("/", 1)[1] for k in logger.mean if k.startswith("test/")])
        return named

    # -- the error-feedback residual in a blob: the reference's [clients,
    # slots, total] carry in its flat layout (under a per-level map, each
    # lossy level's columns in that level's sliced layout), one participant
    def _resid_to_blob(self) -> Optional[np.ndarray]:
        resid = self.engine.wire_resid_host()
        if resid is None:
            return None
        return np.concatenate([flat_to_jax(resid[:, off:off + spec.total], spec.shapes,
                                           self.perms)
                               for off, spec in self.engine.resid_segments()], 1)[None]

    def _resid_from_blob(self, arr) -> np.ndarray:
        arr = np.asarray(arr, np.float32)
        if arr.ndim != 3 or arr.shape[0] != 1:
            raise ValueError(f"checkpointed wire residual of shape {arr.shape}: the port runs "
                             f"one participant and restores a [1, slots, total] carry")
        return np.concatenate([flat_from_jax(arr[0][:, off:off + spec.total], spec.shapes,
                                             self.perms)
                               for off, spec in self.engine.resid_segments()], 1)

    # -- the staleness buffer in a blob: the reference's [2, total] carry in its
    # flat layout (ref entry/common.py:1308-1312, 1464-1465, 1572-1573)
    def _sched_buf_to_blob(self) -> Optional[np.ndarray]:
        buf = self.engine.sched_buf_host() if self.sched.buffered else None
        return None if buf is None else flat_to_jax(buf, self.engine.spec.shapes, self.perms)

    def _flat_from_blob(self, arr) -> np.ndarray:
        return flat_from_jax(np.asarray(arr, np.float32), self.engine.spec.shapes, self.perms)

    def run(self, pivot_metric: str = "Global-Accuracy", pivot_mode: str = "max"
            ) -> Dict[str, Any]:
        """Resume (per ``resume_mode``), then train to ``num_epochs.global``
        with a checkpoint every round and a copy of the best by
        ``test/{pivot_metric}``.  With ``trace_dir`` the run is traced
        (``<trace_dir>/<tag>/trace.json`` and ``events.jsonl``, closed on
        every exit, aborts included); with the ledger its ``ledger.npz`` is
        written on every exit; under the watchdog's ``rollback`` a trip
        restores a checkpoint and retries (:meth:`_recover_rollback`)."""
        cfg, logger = self.cfg, self.logger
        self._ss_dispatched = self._ss_fetched = 0
        self._commitment = ScheduleCommitment(self.sampler_spec.horizon) \
            if self.sampler_spec.committed else None
        blob = resume(cfg["output_dir"], self.tag, cfg["resume_mode"])
        if blob and blob.get("data_split") is not None:
            data_split, label_split = blob["data_split"], blob["label_split"]
        else:
            data_split, label_split = self.make_splits()
        self.stage(data_split, label_split)
        if self.obs_spec.trace_dir and self.tracer is None:
            self.tracer = TraceRecorder(os.path.join(self.obs_spec.trace_dir, self.tag))
            self.phase_timer.trace = self.tracer
        P = self.engine.flatten(self.model.params())
        epoch = 1
        pivot = -math.inf if pivot_mode == "max" else math.inf
        if blob:
            P = self.engine.flatten(params_from_jax(blob["params"], self.perms))
            self._restore_carries(blob, self._supersteps)
            if "epoch" in blob:
                epoch = blob["epoch"]
                pivot = blob.get("pivot", pivot)
                self._restore_loop_state(blob)
        last = cfg["num_epochs"]["global"]
        if epoch <= last:
            # a restored logger state is the checkpointed round's, taken
            # before its reset: the next round's running means start from
            # zero, as in a run that was never interrupted (the reference's
            # first resumed round averages its means with that round's)
            logger.reset()
        if self.tracer is not None:
            self.tracer.instant("run-start", args={"tag": self.tag, "epoch0": int(epoch),
                                                   "rounds": int(last)})
        try:
            while True:
                try:
                    if epoch > last:
                        # inside the recovery loop: a trip the last fetch
                        # surfaces rolls back as any other
                        self._drain_metrics()
                        break
                    P, pivot, epoch = self._run_iteration(P, epoch, last, pivot_metric,
                                                          pivot_mode, pivot, data_split,
                                                          label_split)
                except WatchdogRollback as trip:
                    P, epoch, pivot = self._recover_rollback(trip, pivot_mode)
        finally:
            if self.tracer is not None:
                self.tracer.close()
                self.phase_timer.trace = None
            if self.ledger is not None:
                self.ledger.save(self._ledger_path())
        return {"params": {k: v.clone() for k, v in self.engine.unflatten(P).items()},
                "history": self.history, "logger": logger, "data_split": data_split,
                "label_split": label_split, "bn_state": self.bn_state,
                "wire_resid": self.engine.wire_resid_host(),
                "sched_buf": self.engine.sched_buf_host()}

    def _restore_carries(self, blob: Dict[str, Any], sampler: bool) -> None:
        """A blob's carries back on the engine: the permutation stream at the
        boundary (``sampler``, and only where the blob holds it), the
        residual, the staleness buffer and the ledger."""
        if sampler and blob.get("sampler_state") is not None:
            self.rng.bit_generator.state = blob["sampler_state"]
        if blob.get("wire_resid") is not None and self.engine.lossy:
            self.engine.set_wire_resid(self._resid_from_blob(blob["wire_resid"]))
        if blob.get("sched_buf") is not None and self.sched.buffered:
            # the buffered update still in flight at the checkpoint
            self.engine.set_sched_buf(self._flat_from_blob(blob["sched_buf"]))
        if blob.get("ledger") is not None and self.ledger is not None:
            # the ledger's counts and EMAs go on from the checkpoint
            self.ledger.load_state_dict(blob["ledger"])

    def _restore_loop_state(self, blob: Dict[str, Any]) -> None:
        self.logger.load_state_dict(blob.get("logger_state")
                                    or {"history": blob.get("logger_history", {})})
        if blob.get("scheduler_state") and hasattr(self.scheduler, "load_state_dict"):
            self.scheduler.load_state_dict(blob["scheduler_state"])

    def _load_rollback_blob(self) -> Optional[Dict[str, Any]]:
        """The newest checkpoint generation that verifies AND whose params,
        BN state, residual and staleness carry are all finite (ref
        entry/common.py:1367-1391): a deferred fetch can leave the newest
        generation holding the very NaN the watchdog tripped on.  None when
        no generation qualifies (a fresh restart)."""
        path = checkpoint_path(self.cfg["output_dir"], self.tag)
        for p, blob in iter_verified_generations(path):
            if all(tree_finite(blob.get(k))
                   for k in ("params", "bn_state", "wire_resid", "sched_buf")):
                return blob
            warnings.warn(f"rollback: checkpoint generation {p} verifies but holds non-finite "
                          f"params or carries; falling back a generation")
        return None

    def _recover_rollback(self, trip: WatchdogRollback, pivot_mode: str):
        """One rollback attempt after a watchdog trip (ref entry/common.py:
        1393-1475): the recovery record on the log and the trace; every
        piece of in-flight state dropped -- pending fetches, prefetched
        cohorts (released back to the ring), the commitment's counters, the
        spike window, the engine's carries; the newest usable generation
        restored (params, carries, the permutation stream at its boundary,
        logger and scheduler state), or a fresh start when there is none;
        the round-seed stream (and the permutation stream) salted with
        ``RETRY_SALT + attempt``, so the replayed rounds draw fresh cohorts;
        the backoff slept -> ``(P, epoch, pivot)``.  Past ``max_retries``
        attempts since the last clean checkpoint it escalates to
        :class:`WatchdogError`, the abort path's evidence on disk."""
        spec, logger = self.obs_spec.watchdog, self.logger
        self._rollback_attempts += 1
        attempt = self._rollback_attempts
        if attempt > spec.max_retries:
            self._persist_evidence(close=True)
            raise WatchdogError(
                f"watchdog rollback budget spent ({spec.max_retries} "
                f"attempt(s)): escalating to abort; last trip "
                f"{trip.events[0] if trip.events else trip!r}") from trip
        blob = self._load_rollback_blob()
        rec = {"event": "rollback", "attempt": attempt, "max_retries": spec.max_retries,
               "kind": trip.events[0].get("kind") if trip.events else None,
               "trip_epoch": trip.events[0].get("epoch") if trip.events else None,
               "restored_epoch": (blob or {}).get("epoch"), "fresh_restart": blob is None}
        logger.emit(rec, tag="recovery")
        if self.tracer is not None:
            self.tracer.instant("recovery", cat="obs", args=rec)
        warnings.warn(f"watchdog rollback attempt {attempt}/{spec.max_retries}: restoring "
                      f"{'a fresh init' if blob is None else 'epoch %s' % rec['restored_epoch']} "
                      f"with a salted cohort stream")
        logger.safe(False)  # close the unwound iteration's writer
        self.metrics_pipe.flush()  # discarded: their rounds replay
        for entry in self._next_cohorts:
            entry[2].release()
        self._next_cohorts = []
        self._ss_dispatched = self._ss_fetched = 0
        if self._commitment is not None:
            self._commitment = ScheduleCommitment(self.sampler_spec.horizon)
        if self.watchdog is not None:
            self.watchdog.reset_window()
        self.engine.reset_carries()
        self._checkpoint_recs = {}
        pivot = -math.inf if pivot_mode == "max" else math.inf
        if blob is None:
            P = self.engine.flatten(self.model.params())
            self.logger.load_state_dict({})
            self.scheduler = make_scheduler(self.cfg)
            if self.ledger is not None:
                self.ledger = ClientLedger(self.cfg["num_users"], self.obs_levels)
            self.bn_state = {}
            epoch = 1
        else:
            P = self.engine.flatten(params_from_jax(blob["params"], self.perms))
            self._restore_carries(blob, True)
            self._restore_loop_state(blob)
            self.bn_state = blob.get("bn_state") or {}
            epoch, pivot = blob.get("epoch", 1), blob.get("pivot", pivot)
        logger.reset()
        self.history = [r for r in self.history if r["epoch"] < epoch]
        salt = RETRY_SALT + attempt
        self.stream_seed = salt_seed(self.stream_seed, salt)
        if self.sampler == "perm":
            self.rng = np.random.default_rng([salt, *self.rng.integers(0, 2 ** 32, 2).tolist()])
        if spec.backoff > 0:
            time.sleep(min(spec.backoff * (2 ** (attempt - 1)), 30.0))
        return P, epoch, pivot

    def _run_iteration(self, P, epoch, last, pivot_metric, pivot_mode, pivot, data_split,
                       label_split):
        """One round and its evaluation when due -- or, at
        ``superstep_rounds`` K > 1, a superstep of ``min(K, rounds left)``
        rounds -- then the best-pivot decision and the durable checkpoint
        (ref entry/common.py:1501-1600) -> ``(P, pivot, next epoch)``.  The
        checkpoint's seconds and bytes (the host copy of the params
        included) go into the last round's :attr:`history` record."""
        cfg, logger = self.cfg, self.logger
        logger.safe(True)
        if self._supersteps:
            # a streamed K=1 run is a run of one-round supersteps (ref
            # common.py:1516-1523): its cohorts ride the superstep path
            k = min(self.superstep_rounds, last - epoch + 1)
            with self._trace_span("superstep", {"epoch0": int(epoch), "k": int(k)}):
                P = self.train_superstep(P, epoch, k)
            epoch = epoch + k - 1  # the last round this iteration covered
            # the checkpoint holds end-of-superstep params: only an
            # evaluation of that round, fetched now, may move the pivot
            pivot_fresh = (self.metrics_pipe.fetch_every == 1
                           and (epoch % self.eval_interval == 0 or epoch == last))
        else:
            pivot_fresh = True
            with self._trace_span("round", {"epoch": int(epoch)}):
                P = self.train_round(P, epoch, self.scheduler(epoch))
            if epoch % self.eval_interval == 0 or epoch == last:
                with self._trace_span("eval", {"epoch": int(epoch)}):
                    named = self.evaluate(P, epoch)  # first: it logs the rounds still pending
                self.history[-1].update(named)
                if isinstance(self.scheduler, PlateauScheduler):
                    # min-mode plateau on the test Global loss, on evaluated rounds
                    self.scheduler.step_metric(logger.mean.get("test/Global-Loss", 0.0))
        logger.safe(False)
        cur = logger.history.get(f"test/{pivot_metric}", [None])[-1]
        is_best = pivot_fresh and pivot_improves(cur, pivot, pivot_mode)
        if is_best:
            pivot = cur  # before saving, so a resumed run keeps it
        # a rollback restores the permutation stream's boundary, K=1 too
        rollback = self.watchdog is not None and self.watchdog.spec.action == "rollback"
        blob = lambda: {  # noqa: E731
            "cfg": {k: v for k, v in cfg.items() if k != "vocab"},
            "epoch": epoch + 1,
            "data_split": data_split,
            "label_split": label_split,
            "params": params_to_jax(self.engine.unflatten(P), self.perms),
            "bn_state": self.bn_state,
            "wire_resid": self._resid_to_blob(),
            "sched_buf": self._sched_buf_to_blob(),
            "ledger": self.ledger.state_dict() if self.ledger is not None else None,
            "pivot": pivot,
            "logger_history": dict(logger.history),
            "logger_state": logger.state_dict(),
            "scheduler_state": self.scheduler.state_dict()
            if hasattr(self.scheduler, "state_dict") else None,
            **({"sampler_state": self._sampler_state()} if self._supersteps or rollback else {}),
        }
        if self.history and self.history[-1]["epoch"] == epoch:
            rec = self.history[-1]
        else:  # the round's metrics are still in the pipeline: its record takes this later
            rec = self._checkpoint_recs.setdefault(epoch, {"epoch": epoch})
        with self._trace_span("checkpoint", {"epoch": int(epoch)}):
            write_checkpoint(cfg["output_dir"], self.tag, blob, self.checkpoint_keep, is_best,
                             rec)
        logger.reset()
        # a clean iteration ending in a durable checkpoint re-arms the
        # rollback budget for the next incident
        self._rollback_attempts = 0
        return P, pivot, epoch + 1


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
