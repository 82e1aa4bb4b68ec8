"""Configuration: defaults, control-string codec, derived hyperparameters.

Port of ``heterofl_tpu/config.py`` for the vision and masked-LM paths, in
both rate modes (``fix`` and ``dynamic``).  ``DEFAULT_CFG``
holds the keys this package reads, plus the keys of features it does not
port yet, pinned to the value that turns each feature off.  Setting any of
those to another value raises ``NotImplementedError`` naming the key
(:func:`check_ported`), so nothing is silently ignored -- but for the
reference's own inert keys (``shuffle``, ``num_workers``,
``metric_name``, ``log_interval``, ``save_format``, ``param_dtype``),
which the reference accepts and reads nowhere, and this package likewise.

Differences from the reference's defaults: ``device`` is ``"cuda"`` (the
reference's is ``"tpu"``), and ``sampler`` is ``"perm"`` -- the numpy
permutation stream of the reference's experiment loop, the one cohort draw
that does not need ``jax.random``, which keeps a K=1 run's cohorts equal to
the reference's bit for bit.  ``sampler='prp'`` (the reference's default,
``fed/sampling.py``) is accepted: its Feistel round keys come from the
port's own per-round seed, so its cohorts are the reference's map under
other keys.

``superstep_rounds`` K > 1 runs K rounds a dispatch, their local steps and
evaluation forwards replayed from CUDA graphs (``parallel/step_graph.py``),
and ``metrics_fetch_every`` defers the host's metric fetch
(:func:`resolve_superstep_cfg` holds the cross-field checks of
heterofl_tpu/entry/common.py:336-416).

``client_store='stream'`` keeps the population as an O(1)-per-user index
(``parallel/staging.py::ClientStore``) and stages each superstep's cohort
onto the device while the previous superstep runs (``stream_prefetch``,
``stream_prefetch_depth``); ``sample_horizon`` commits the cohort schedule
(``fed/sampling.py::ScheduleCommitment``); ``eval_cohort`` evaluates Local
on a rolling window of users.  :func:`resolve_store_cfg`,
:func:`resolve_prefetch_depth` and :func:`resolve_eval_cohort` check them
with the reference's messages (heterofl_tpu/config.py:650-787).

``schedule`` and ``client_failure_rate`` run the client scheduler
(``sched/``: availability traces, deadline stragglers, buffered
aggregation, client failures) on ``masked`` and ``grouped``;
``sched.resolve_schedule_cfg`` checks them once ``num_users`` is known, at
the end of :func:`process_control`.

``telemetry``, ``watchdog``, ``quarantine``, ``ledger``, ``trace_dir``,
``profile_dir`` and ``chaos_poison`` run the observability and its guards
(``obs/``, ``chaos/``); ``obs.resolve_telemetry_cfg``,
``obs.resolve_ledger_cfg``, ``obs.resolve_quarantine_cfg`` and
``chaos.resolve_poison_cfg`` check them with the reference's messages, in
the reference's order, at the end of :func:`process_control`.

``arms`` runs E experiment arms in one superstep (``multi/``,
``entry.common.ArmsExperiment``); ``multi.resolve_arms_cfg`` checks it, and
its cross-field refusals, last, as the reference's ``process_control``
does (heterofl_tpu/config.py:571-594).
"""

from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .chaos import resolve_poison_cfg
from .compress import resolve_codec_cfg
from .fed.sampling import resolve_sampler_cfg
from .multi import resolve_arms_cfg
from .obs import resolve_ledger_cfg, resolve_quarantine_cfg, resolve_telemetry_cfg
from .sched import resolve_schedule_cfg

# Width multiplier per complexity level (ref src/utils.py:114).
MODEL_SPLIT_RATE: Dict[str, float] = {"a": 1.0, "b": 0.5, "c": 0.25, "d": 0.125, "e": 0.0625}

CONTROL_KEYS = ("fed", "num_users", "frac", "data_split_mode", "model_split_mode",
                "model_mode", "norm", "scale", "mask")

#: the round engines (heterofl_tpu/config.py:47)
STRATEGIES = ("masked", "grouped", "sliced")

#: the client stores (heterofl_tpu/config.py:49)
CLIENT_STORES = ("eager", "stream")
#: the data and level placements (heterofl_tpu/config.py:48-49)
DATA_PLACEMENTS = ("replicated", "sharded")
LEVEL_PLACEMENTS = ("span", "slices")

MNIST_LIKE = ("MNIST", "FashionMNIST", "EMNIST")
CIFAR_LIKE = ("CIFAR10", "CIFAR100")
VISION_DATASETS = MNIST_LIKE + CIFAR_LIKE
LM_DATASETS = ("PennTreebank", "WikiText2", "WikiText103")

DEFAULT_CFG: Dict[str, Any] = {
    "control": {"fed": "1", "num_users": "100", "frac": "0.1", "data_split_mode": "iid",
                "model_split_mode": "fix", "model_mode": "a1", "norm": "bn",
                "scale": "1", "mask": "1"},
    "data_name": "CIFAR10",
    "subset": "label",
    "batch_size": {"train": 128, "test": 128},
    # accepted and ignored, as in the reference, which reads none of them
    # (heterofl_tpu/config.py:72-133): the stacks are shuffled by the
    # round's permutation stream, nothing loads in worker processes, the
    # metrics and the log cadence are fixed, params are float32
    # (compute_dtype narrows the operands), and save_format is the figure
    # format of the original's process.py (analysis/process.py takes
    # --save_format itself)
    "shuffle": {"train": True, "test": False},
    "num_workers": 0,
    "metric_name": {"train": ["Loss", "Accuracy"], "test": ["Loss", "Accuracy"]},
    "log_interval": 0.25,
    "save_format": "pdf",
    "param_dtype": "float32",
    "model_name": "resnet18",
    "optimizer_name": "Adam",
    "lr": 3.0e-4,
    "momentum": 0.9,
    "weight_decay": 5.0e-4,
    "scheduler_name": "None",
    "step_size": 1,
    "milestones": [100, 150],
    # ReduceLROnPlateau's patience and relative threshold, and the floor of
    # ReduceLROnPlateau and CosineAnnealingLR (heterofl_tpu/config.py:83-86)
    "patience": 10,
    "threshold": 1.0e-3,
    "factor": 0.5,
    "min_lr": 1.0e-4,
    "init_seed": 0,
    "num_experiments": 1,
    "num_epochs": 200,
    "device": "cuda",
    # masked: every client at full width with masks (parallel/round_engine.py);
    # grouped: each level's clients batched through its dense sub-model
    # (parallel/grouped.py); sliced: the host-orchestrated twin (fed/sliced.py)
    "strategy": "masked",
    # train-time BN through the hand-written CUDA kernels (ops/fused_norm.py)
    "pallas_norm": False,
    # fused masked-SGD epilogue over flat buffers (ops/fused_update.py):
    # True = the CUDA kernel on a CUDA device, its plain version on the CPU;
    # "cuda" = the kernel or raise; False = the unfused per-leaf chain
    "fused_update": True,
    # bfloat16 | float32 (aliases bf16; f32, fp32, None): the dtype of each
    # conv's and linear's operands (parse_compute_dtype)
    "compute_dtype": "float32",
    # None (direct, "direct") | "im2col": patch extraction plus a matmul
    # (ops/layers.py::conv2d; parse_conv_impl)
    "conv_impl": None,
    # the reference's scan unroll; the port replays its steps one by one, so
    # any value >= 1 is accepted and changes nothing (parse_scan_unroll)
    "scan_unroll": 1,
    # compressed aggregation (compress/): dense | int8 | signsgd | topk, and
    # the lossy codecs' error-feedback residual
    "wire_codec": "dense",
    "error_feedback": True,
    # sBN + Local/Global evaluation every this many rounds, and after the last
    "eval_interval": 1,
    "sampler": "perm",
    # K rounds a dispatch (the superstep; 1: one round a dispatch, eager),
    # and the host's metric fetch every this many rounds (1 or K at K > 1)
    "superstep_rounds": 1,
    "metrics_fetch_every": 1,
    # "eager": every user's shard stacked onto the device at start-up
    # ([num_users, ...]; memory grows with the population); "stream": the
    # population as an O(1)-per-user index over the raw arrays
    # (parallel/staging.py::ClientStore), each superstep's sampled cohort
    # gathered into pinned host memory and copied onto the device while
    # the previous superstep runs -- memory grows with the cohort.  Streamed
    # runs equal eager ones bit for bit; a streamed superstep_rounds=1 run
    # is a run of k=1 supersteps.  Needs 'masked' or 'grouped'.
    "client_store": "eager",
    # True: stage superstep N+1's cohort right after superstep N is
    # dispatched, so the gather and the copy overlap N's compute; False:
    # stage each cohort when its superstep starts (warned once)
    "stream_prefetch": True,
    # how many upcoming supersteps' cohorts may be staged ahead of the one
    # in flight; the stager's ring holds depth + 1 slots (resolve_prefetch_depth)
    "stream_prefetch_depth": 1,
    # schedule commitment: None = stateless sampler (the cohort schedule a
    # function of the seed and the stream alone, prefetch unconstrained); an
    # int >= 0 = superstep N+1's cohort may only be drawn once superstep
    # N - sample_horizon's metrics are fetched (fed/sampling.py::
    # ScheduleCommitment).  Both samplers ignore the committed state, so the
    # committed schedule equals the immediate one
    "sample_horizon": None,
    # with client_store='stream' (vision): the per-user Local evaluation on
    # a rolling window of this many consecutive users (the window advances
    # with each evaluation, deterministic in the epoch), sBN and Global on
    # their full sets; None = every user (warned past 100,000 users)
    "eval_cohort": None,
    # the client scheduler (sched/): None (lockstep) or {"kind": "uniform" |
    # "trace" | "markov", "trace", "markov", "deadline": {"min_frac": f},
    # "aggregation": "sync" | "buffered", "staleness"} (resolve_schedule_cfg)
    "schedule": None,
    # each round a client fails with this probability: its update never
    # reaches the aggregate (fed.core.client_alive)
    "client_failure_rate": 0.0,
    "data_dir": "./data",
    "output_dir": "./output",
    "synthetic": False,
    "synthetic_sizes": None,
    # 0 fresh, 1 full resume, 2 params and splits only (utils/checkpoint.py)
    "resume_mode": 0,
    # checkpoint generations kept (the live blob and keep - 1 older ones)
    "checkpoint_keep": 3,
    "use_tensorboard": False,
    # observability (obs/): "off" | "on" (health probes) | "hist" (and the
    # cohort histograms); the watchdog on the probes ({"action": "warn" |
    # "abort" | "rollback" | "off", "spike_factor", "window", "max_retries",
    # "backoff"}); the client-update quarantine ("off" | "on" | {"max_norm":
    # R}); the client ledger ("off" | "on"); the run trace's directory
    # (trace.json, events.jsonl); a torch.profiler trace of the first steady
    # round or superstep into profile_dir
    "telemetry": "off",
    "watchdog": None,
    "quarantine": "off",
    "ledger": "off",
    "trace_dir": None,
    "profile_dir": None,
    # [[round, uid], ...]: those client updates are made NaN before
    # aggregation (chaos/), how the quarantine and the rollback are proved
    "chaos_poison": None,
    # experiment arms (multi/): None, an int count, or {"count": E, "seeds":
    # [None | int, ...], "lr_scales": [...]} -- E arms of the run trained in
    # one superstep by entry.common.ArmsExperiment (resolve_arms_cfg)
    "arms": None,
    # the clients mesh axis (parallel/mesh.py): every rank of the process
    # group torchrun launches (0), as the reference's every device; any
    # other count must be the world size, and a data or arms axis is not
    # ported (ROADMAP Queue 1 item 5)
    "mesh": {"clients": 0, "data": 1},
    # accepted and ignored, as in the reference, which reads it only in
    # analysis/compare_reference.py: the world is the process group's
    "world_size": 1,
    # "replicated": every rank holds every user's train shard; "sharded":
    # rank r holds only its block of users (the user axis padded to a
    # multiple of the ranks) and trains the cohort's users it holds
    "data_placement": "replicated",
    # the grouped engine's level placement: "span" (every level over every
    # rank) or "slices" (each level over its own block of ranks, sized by
    # its expected FLOP share); slice_align n > 0 lays the blocks out in
    # chunks of ranks / n ranks, and strict_placement raises where a slices
    # table cannot be laid out instead of falling back to span (the
    # reference reads the last two through cfg.get, heterofl_tpu/parallel/
    # grouped.py:279, :325)
    "level_placement": "span",
    "slice_align": 0,
    "strict_placement": False,
    "override": {},
}

#: keys of reference features this package does not port yet, each with the
#: value that turns its feature off (heterofl_tpu/config.py:57-355); none is
#: left, and a key put here is refused by :func:`check_ported`
UNPORTED: Dict[str, Any] = {}
#: the ROADMAP item of each key in UNPORTED
UNPORTED_ITEM: Dict[str, str] = {}
DEFAULT_CFG.update(copy.deepcopy(UNPORTED))


def default_cfg() -> Dict[str, Any]:
    return copy.deepcopy(DEFAULT_CFG)


def resolve_strategy_cfg(cfg: Dict[str, Any]) -> str:
    """Validate ``cfg['strategy']`` and return it (heterofl_tpu/config.py:
    598-606): an unknown strategy raises ``ValueError``."""
    strategy = cfg.get("strategy", "masked") or "masked"
    if strategy not in STRATEGIES:
        raise ValueError(f"Not valid strategy: {strategy!r} (one of {STRATEGIES})")
    return strategy


def parse_compute_dtype(cd) -> Optional[torch.dtype]:
    """``cfg['compute_dtype']`` -> ``torch.bfloat16``, or None for float32
    (ref models/__init__.py:42-50): ``bfloat16``/``bf16`` and
    ``float32``/``f32``/``fp32``/None; anything else raises ``ValueError``."""
    if cd in ("bfloat16", "bf16"):
        return torch.bfloat16
    if cd in (None, "float32", "f32", "fp32"):
        return None
    raise ValueError(f"Not valid compute_dtype: {cd!r} (float32 | bfloat16)")


def parse_conv_impl(impl) -> Optional[str]:
    """``cfg['conv_impl']`` -> ``"im2col"`` or None (direct; ``"direct"``
    means None); anything else raises ``ValueError`` (ref
    models/__init__.py:60-64)."""
    if impl not in (None, "direct", "im2col"):
        raise ValueError(f"Not valid conv_impl: {impl!r}")
    return None if impl == "direct" else impl


def parse_scan_unroll(cfg: Dict[str, Any]) -> int:
    """``cfg['scan_unroll']`` as the reference parses it
    (``int(cfg.get("scan_unroll", 1) or 1)``, ref parallel/round_engine.py:
    414); below 1 raises ``ValueError``.  The reference unrolls its local
    step scan by it; the port has no scan (each step is a replayed graph),
    so the value changes nothing here."""
    unroll = int(cfg.get("scan_unroll", 1) or 1)
    if unroll < 1:
        raise ValueError(f"Not valid scan_unroll: {cfg['scan_unroll']!r} (an int >= 1)")
    return unroll


def check_ported(cfg: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError`` naming the first key whose value asks
    for a feature this package does not port yet, and ``ValueError`` for a
    strategy or wire codec setting that is not valid (:func:`resolve_strategy_cfg`,
    :func:`~.compress.resolve_codec_cfg`)."""
    resolve_strategy_cfg(cfg)
    for key, off in UNPORTED.items():
        if key in cfg and cfg[key] != off:
            raise NotImplementedError(
                f"cfg[{key!r}] = {cfg[key]!r} is not ported to heterofl_tpu_torch "
                f"yet (only {off!r} is; {UNPORTED_ITEM[key]})")
    resolve_placement_cfg(cfg)
    parse_compute_dtype(cfg.get("compute_dtype"))
    parse_conv_impl(cfg.get("conv_impl"))
    parse_scan_unroll(cfg)
    resolve_sampler_cfg(cfg)
    resolve_codec_cfg(cfg)


def resolve_superstep_cfg(cfg: Dict[str, Any], plateau: bool = False) -> Tuple[int, int]:
    """``(K, fetch_every)``: the rounds a dispatch and the metrics
    pipeline's fetch interval in dispatches (``metrics_fetch_every // K`` at
    K > 1), after the reference experiment loop's cross-field checks
    (heterofl_tpu/entry/common.py:336-395), which raise ``ValueError`` with
    its messages: K > 1 with ``sliced``; a ``metrics_fetch_every`` other
    than 1 that K does not divide, or above K; ReduceLROnPlateau
    (``plateau``) with an ``eval_interval`` that K does not divide; and, at
    K = 1, a ``metrics_fetch_every`` above 1 with the stream store (the
    reference's configuration message, heterofl_tpu/config.py:717-724)."""
    K = max(1, int(cfg.get("superstep_rounds", 1) or 1))
    fetch_every = int(cfg.get("metrics_fetch_every", 1) or 1)
    eval_iv = max(1, int(cfg.get("eval_interval", 1) or 1))
    if K == 1:
        if resolve_store_cfg(cfg) == "stream" and fetch_every > 1:
            raise ValueError(
                f"Not valid metrics_fetch_every={fetch_every} with "
                f"client_store='stream' at superstep_rounds=1: streaming "
                f"routes through the (k=1) superstep path, whose "
                f"best-checkpoint pivot needs a synchronous fetch; use 1")
        return 1, max(1, fetch_every)
    if (cfg.get("strategy") or "masked") == "sliced":
        raise ValueError(
            "superstep_rounds>1 needs a mesh-native engine "
            "(strategy 'masked' or 'grouped'); 'sliced' is the "
            "host-orchestrated debug twin")
    if fetch_every != 1 and fetch_every % K:
        raise ValueError(
            f"metrics_fetch_every={fetch_every} conflicts with "
            f"superstep_rounds={K}: a superstep fetches its metrics "
            f"exactly once per K rounds (use 1 for synchronous fetch "
            f"or exactly {K}; larger multiples would defer metrics "
            f"past the superstep's checkpoint)")
    if plateau:
        if eval_iv % K:
            raise ValueError(
                f"ReduceLROnPlateau with superstep_rounds={K} needs "
                f"eval boundaries on superstep boundaries "
                f"(eval_interval % superstep_rounds == 0, got "
                f"eval_interval={eval_iv}): a mid-superstep eval "
                f"would require an LR step inside the compiled scan")
        if fetch_every > K:
            raise ValueError(
                f"ReduceLROnPlateau feeds on each superstep's eval "
                f"metrics before the next superstep dispatches; "
                f"metrics_fetch_every={fetch_every} would defer them "
                f"(use 1 or {K})")
    if fetch_every > K:
        raise ValueError(
            f"metrics_fetch_every={fetch_every} exceeds "
            f"superstep_rounds={K}: each superstep's eval metrics "
            f"would be deferred past its checkpoint, silently "
            f"disabling best-checkpoint tracking (pivot never "
            f"fresh); use 1 or {K}")
    return K, max(1, fetch_every // K)


def parse_control_name(control_name: str) -> Dict[str, str]:
    """Split an underscore-separated control string into the 9 fields."""
    if control_name in (None, "None", ""):
        return {}
    parts = control_name.split("_")
    if len(parts) != len(CONTROL_KEYS):
        raise ValueError(f"control string must have {len(CONTROL_KEYS)} fields "
                         f"{CONTROL_KEYS}, got {len(parts)}: {control_name!r}")
    return dict(zip(CONTROL_KEYS, parts))


def control_name_of(control: Dict[str, str]) -> str:
    return "_".join(control[k] for k in CONTROL_KEYS)


def make_model_tag(seed: int, cfg: Dict[str, Any]) -> str:
    parts = [str(seed), cfg["data_name"], cfg.get("subset", ""), cfg["model_name"],
             cfg["control_name"]]
    return "_".join(x for x in parts if x)


def _fix_rate_vector(mode_rate: List[float], proportion: List[int], num_users: int) -> List[float]:
    """Per-user rates in ``fix`` mode: ``num_users // sum(proportion) *
    proportion_i`` users per level in level order, the remainder at the last
    level's rate (ref src/utils.py:134-144)."""
    if num_users < sum(proportion):
        raise ValueError(f"fix mode needs num_users >= sum of proportions: {num_users} "
                         f"users < {sum(proportion)}")
    per = num_users // sum(proportion)
    rates: List[float] = []
    for r, p in zip(mode_rate, proportion):
        rates += [r] * (per * p)
    rates += [rates[-1]] * (num_users - len(rates))
    return [float(r) for r in rates]


def process_control(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Expand ``cfg['control']`` into every derived hyperparameter the
    vision and LM paths read (heterofl_tpu/config.py:412-556).  Returns a
    new dict.  An LM dataset's ``num_tokens`` and ``classes_size`` come from
    its vocabulary (:func:`~.data.process_dataset`).  ``pallas_norm`` has
    no effect on the transformer: it has no batch norm."""
    cfg = copy.deepcopy(cfg)
    check_ported(cfg)
    ctl = cfg["control"]
    cfg["control_name"] = control_name_of(ctl)
    cfg["model_split_rate"] = dict(MODEL_SPLIT_RATE)
    cfg["fed"] = int(ctl["fed"])
    cfg["num_users"] = int(ctl["num_users"])
    cfg["frac"] = float(ctl["frac"])
    cfg["data_split_mode"] = ctl["data_split_mode"]
    cfg["model_split_mode"] = ctl["model_split_mode"]
    cfg["model_mode"] = ctl["model_mode"]
    cfg["norm"] = ctl["norm"]
    cfg["scale"] = bool(int(ctl["scale"]))
    cfg["mask"] = bool(int(ctl["mask"]))
    cfg["global_model_mode"] = cfg["model_mode"][0]
    cfg["global_model_rate"] = cfg["model_split_rate"][cfg["global_model_mode"]]
    mode_rate, proportion = [], []
    for m in cfg["model_mode"].split("-"):
        mode_rate.append(cfg["model_split_rate"][m[0]])
        proportion.append(int(m[1:]))
    if cfg["model_split_mode"] == "fix":
        cfg["model_rate"] = _fix_rate_vector(mode_rate, proportion, cfg["num_users"])
    elif cfg["model_split_mode"] == "dynamic":
        # the mode rates and their normalised weights: every user's rate is
        # drawn anew each round (fed.core.round_rates)
        cfg["model_rate"] = mode_rate
        cfg["proportion"] = (np.array(proportion) / sum(proportion)).tolist()
    else:
        raise ValueError("Not valid model split mode")
    cfg["conv"] = {"hidden_size": [64, 128, 256, 512]}
    cfg["resnet"] = {"hidden_size": [64, 128, 256, 512]}
    cfg["transformer"] = {"embedding_size": 256, "num_heads": 8, "hidden_size": 512,
                          "num_layers": 4, "dropout": 0.2}
    data_name, split = cfg["data_name"], cfg["data_split_mode"]
    if data_name not in VISION_DATASETS + LM_DATASETS:
        raise NotImplementedError(
            f"data_name={data_name!r} is not ported to heterofl_tpu_torch yet "
            f"(one of {VISION_DATASETS + LM_DATASETS})")
    cfg["optimizer_name"] = "SGD"
    cfg["momentum"] = 0.9
    cfg["weight_decay"] = 5e-4
    cfg["scheduler_name"] = "MultiStepLR"
    cfg["factor"] = 0.1
    # (global rounds, local epochs, milestones, train batch, test batch) per
    # split kind; "none" is centralised training: epochs, not rounds
    if data_name in MNIST_LIKE:
        cfg["lr"] = 1e-2
        table = {"iid": (200, 5, [100], 10, 50), "non-iid": (400, 5, [200], 10, 50),
                 "none": (200, None, [100], 100, 500)}
    elif data_name in CIFAR_LIKE:
        cfg["lr"] = 1e-1
        table = {"iid": (400, 5, [150, 250], 10, 50), "non-iid": (800, 5, [300, 500], 10, 50),
                 "none": (400, None, [150, 250], 100, 500)}
    else:  # LM: batch = rows of the batchified token stream
        cfg["lr"] = 1e-1
        cfg["bptt"] = 64
        cfg["mask_rate"] = 0.15
        table = {"iid": (200, 1, [50, 100], 100, 10), "none": (100, None, [25, 50], 100, 100)}
    if data_name in VISION_DATASETS:
        cfg["data_shape"] = [28, 28, 1] if data_name in MNIST_LIKE else [32, 32, 3]  # NHWC
    kind = "non-iid" if "non-iid" in split else split
    if kind not in table:
        raise ValueError("Not valid data_split_mode")
    glob, local, cfg["milestones"], b_train, b_test = table[kind]
    cfg["num_epochs"] = glob if kind == "none" else {"global": glob, "local": local}
    cfg["batch_size"] = {"train": b_train, "test": b_test}
    for k, v in (cfg.get("override") or {}).items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    check_ported(cfg)
    resolve_store_cfg(cfg)
    resolve_prefetch_depth(cfg)
    resolve_schedule_cfg(cfg)  # needs num_users (a markov trace, a trace's width)
    resolve_eval_cohort(cfg)
    resolve_telemetry_cfg(cfg)
    resolve_ledger_cfg(cfg)
    resolve_quarantine_cfg(cfg)
    resolve_checkpoint_keep(cfg)
    resolve_poison_cfg(cfg)
    resolve_arms_cfg(cfg)
    resolve_mesh_cfg(cfg)
    return cfg


def launched_world_size() -> int:
    """The number of ranks this process runs among: the joined process
    group's size, else torchrun's ``WORLD_SIZE`` (1 without it)."""
    import os

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def resolve_placement_cfg(cfg: Dict[str, Any]) -> Tuple[str, str]:
    """Validate ``cfg['data_placement']`` and ``cfg['level_placement']``
    and return them, with the reference's checks and messages
    (heterofl_tpu/config.py:609-650): an unknown placement, ``sharded``
    with ``grouped``, ``slices`` with another engine than ``grouped``, and
    either placement knob with ``sliced`` raise ``ValueError``; so do a
    ``slice_align`` other than an int >= 0 and a ``strict_placement`` other
    than a bool (the reference takes either as it comes)."""
    strategy = resolve_strategy_cfg(cfg)
    dp = cfg.get("data_placement", "replicated") or "replicated"
    lp = cfg.get("level_placement", "span") or "span"
    if dp not in DATA_PLACEMENTS:
        raise ValueError(f"Not valid data_placement: {dp!r} "
                         f"(one of {DATA_PLACEMENTS})")
    if lp not in LEVEL_PLACEMENTS:
        raise ValueError(f"Not valid level_placement: {lp!r} "
                         f"(one of {LEVEL_PLACEMENTS})")
    if strategy == "grouped" and dp == "sharded":
        raise ValueError(
            "Not valid data_placement='sharded' with strategy='grouped': "
            "a level's clients span the whole clients axis, so the grouped "
            "engine packs slot schedules from the replicated store; use "
            "strategy='masked' for sharded placement")
    if lp == "slices" and strategy != "grouped":
        raise ValueError(
            f"Not valid level_placement='slices' with strategy="
            f"{strategy!r}: the slices partition assigns each rate level "
            f"its own clients-axis device rows, which only the grouped "
            f"engine's per-level dense programs consume")
    if strategy == "sliced" and dp != "replicated":
        raise ValueError(
            f"Not valid data_placement={dp!r} with strategy='sliced': the "
            f"host-orchestrated debug twin replays the reference loop and "
            f"ignores device placement -- the knob would silently no-op")
    align = cfg.get("slice_align") or 0
    if not isinstance(align, int) or isinstance(align, bool) or align < 0:
        raise ValueError(f"Not valid slice_align: {align!r} (an int >= 0)")
    if not isinstance(cfg.get("strict_placement") or False, bool):
        raise ValueError(f"Not valid strict_placement: {cfg['strict_placement']!r} (a bool)")
    return dp, lp


#: what the clients mesh axis does not carry yet at a world of several
#: ranks: (the cfg's test, what it is, its ROADMAP item)
MESH_REFUSALS = (
    (lambda c: (c.get("client_store") or "eager") == "stream", "client_store='stream'",
     "ROADMAP Queue 1 item 5, the stream store on the mesh"),
    (lambda c: c.get("arms") is not None, "arms",
     "ROADMAP Queue 1 item 5, the arms axis"),
    (lambda c: (c.get("telemetry") or "off") != "off" or (c.get("quarantine") or "off") != "off"
     or c.get("chaos_poison") is not None or c.get("watchdog") is not None,
     "telemetry, quarantine, watchdog or chaos_poison",
     "ROADMAP Queue 1 item 5, observability on the mesh"),
)


#: what the data axis does not carry yet: (the cfg's test, what it is, its
#: ROADMAP item), refused at ``data > 1`` whatever the world; empty, as
#: every engine runs on it
DATA_REFUSALS: Tuple[Tuple[Callable[[Dict[str, Any]], bool], str, str], ...] = ()


def resolve_mesh_cfg(cfg: Dict[str, Any], world: Optional[int] = None) -> Dict[str, int]:
    """Validate ``cfg['mesh']`` and return it with its defaults: ``clients``
    (0: every rank) and ``data`` and ``arms`` (1), each an int >= 0 (the
    axes themselves are checked by ``parallel.mesh.make_mesh``).  At a
    world of several ranks (``world``, default :func:`launched_world_size`)
    each option the clients axis does not carry yet raises
    ``NotImplementedError`` naming its ROADMAP item: nothing silently runs
    on one rank instead.  ``data > 1`` (the data axis, ``parallel/mesh.py``)
    refuses what :data:`DATA_REFUSALS` names likewise (nothing now), and an
    LM, masked or grouped, needs ``bptt % data == 0`` (the reference's
    ``ValueError``, round_engine.py:767-769)."""
    spec = dict(cfg.get("mesh") or {})
    bad = sorted(set(spec) - {"clients", "data", "arms"})
    if bad:
        raise ValueError(f"Not valid mesh keys {bad} (clients, data, arms)")
    out = {"clients": spec.get("clients", 0), "data": spec.get("data", 1),
           "arms": spec.get("arms", 1)}
    for k, v in out.items():
        if v is None:
            out[k] = 0 if k == "clients" else 1
        elif not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"Not valid mesh {k}: {v!r} (an int >= 0)")
    n_data = out["data"] or 1
    if n_data > 1:
        for test, what, item in DATA_REFUSALS:
            if test(cfg):
                raise NotImplementedError(
                    f"{what} at mesh data={n_data}: the data axis does not carry it yet "
                    f"({item}); run it at data=1")
        if cfg.get("model_name") == "transformer" and cfg.get("bptt") and cfg["bptt"] % n_data:
            raise ValueError(f"data axis size ({n_data}) must divide bptt={cfg['bptt']} "
                             f"for sequence-parallel LM rounds")
    world = launched_world_size() if world is None else int(world)
    if world > 1:
        for test, what, item in MESH_REFUSALS:
            if test(cfg):
                raise NotImplementedError(
                    f"{what} at a world of {world} ranks: the clients mesh axis does not "
                    f"carry it yet ({item}); run it on one rank")
    return out


def resolve_store_cfg(cfg: Dict[str, Any]) -> str:
    """Validate ``cfg['client_store']`` (and ``stream_prefetch``) and return
    it, with the reference's messages (heterofl_tpu/config.py:650-671): an
    unknown store, and the stream store with ``sliced``, raise
    ``ValueError``.  ``stream_prefetch`` must be a bool (the reference
    takes ``bool()`` of anything, so a typo there silently stages
    synchronously)."""
    strategy = resolve_strategy_cfg(cfg)
    store = cfg.get("client_store", "eager") or "eager"
    if store not in CLIENT_STORES:
        raise ValueError(f"Not valid client_store: {store!r} "
                         f"(one of {CLIENT_STORES})")
    if store == "stream" and strategy == "sliced":
        raise ValueError(
            "Not valid client_store='stream' with strategy='sliced': the "
            "cohort pipeline stages through the mesh-native engines' "
            "superstep programs ('masked' or 'grouped')")
    prefetch = cfg.get("stream_prefetch", True)
    if not isinstance(prefetch, bool):
        raise ValueError(f"Not valid stream_prefetch: {prefetch!r} (a bool: True stages "
                         f"the next superstep's cohort while this one runs)")
    return store


def resolve_prefetch_depth(cfg: Dict[str, Any]) -> int:
    """Validate ``cfg['stream_prefetch_depth']`` and return it
    (heterofl_tpu/config.py:727-740): an int >= 1, None meaning 1."""
    depth = cfg.get("stream_prefetch_depth", 1)
    if depth is None:
        return 1
    if not isinstance(depth, int) or isinstance(depth, bool) or depth < 1:
        raise ValueError(f"Not valid stream_prefetch_depth: {depth!r} "
                         f"(an int >= 1)")
    return depth


def resolve_eval_cohort(cfg: Dict[str, Any]) -> Optional[int]:
    """Validate ``cfg['eval_cohort']`` and return it (heterofl_tpu/config.py:
    757-787): None, or an int in ``[1, num_users]`` with the stream store
    on a vision model."""
    ec = cfg.get("eval_cohort")
    if ec is None:
        return None
    if not isinstance(ec, int) or isinstance(ec, bool) or ec < 1:
        raise ValueError(f"Not valid eval_cohort: {ec!r} (an int >= 1, the "
                         f"rolling Local-eval window size, or None for "
                         f"whole-population local eval)")
    users = cfg.get("num_users")
    if users is not None and ec > int(users):
        raise ValueError(f"Not valid eval_cohort: {ec} exceeds "
                         f"num_users={users} (drop eval_cohort for "
                         f"whole-population local eval)")
    if (cfg.get("client_store", "eager") or "eager") != "stream":
        raise ValueError(
            f"Not valid eval_cohort={ec} with client_store='eager': the "
            f"eager store already densifies the population, so its local "
            f"eval is O(num_users) either way -- eval_cohort needs "
            f"client_store='stream'")
    if cfg.get("model_name") == "transformer":
        raise ValueError(
            f"Not valid eval_cohort={ec} with model_name='transformer': "
            f"eval_cohort samples the per-user Local eval, which only "
            f"vision experiments run (LM evaluates Global only)")
    return ec


def resolve_checkpoint_keep(cfg: Dict[str, Any]) -> int:
    """Validate ``cfg['checkpoint_keep']`` and return it
    (heterofl_tpu/config.py:742-755): ``process_control`` applies it and
    the experiment loop again, so a malformed value fails at configuration
    time, never as a silent single-generation fallback mid-run."""
    keep = cfg.get("checkpoint_keep", 3)
    if keep is None:
        return 3
    if not isinstance(keep, int) or isinstance(keep, bool) or keep < 1:
        raise ValueError(f"Not valid checkpoint_keep: {keep!r} (an int >= 1 "
                         f"checkpoint generations to retain)")
    return keep


def ceil_width(size: int, rate: float) -> int:
    """Active width of a sliced dimension: ``ceil(size * rate)``."""
    return int(math.ceil(size * rate))


def scaled_hidden(hidden_size: List[int], model_rate: float) -> List[int]:
    return [ceil_width(x, model_rate) for x in hidden_size]

