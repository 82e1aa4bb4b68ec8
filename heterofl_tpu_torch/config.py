"""Configuration: defaults, control-string codec, derived hyperparameters.

Port of ``heterofl_tpu/config.py`` for the vision and masked-LM paths, in
both rate modes (``fix`` and ``dynamic``).  ``DEFAULT_CFG``
holds the keys this package reads, plus the keys of features it does not
port yet, pinned to the value that turns each feature off.  Setting any of
those to another value raises ``NotImplementedError`` naming the key
(:func:`check_ported`), so nothing is silently ignored.

Differences from the reference's defaults: ``device`` is ``"cuda"`` (the
reference's is ``"tpu"``), and ``sampler`` is ``"perm"`` -- the numpy
permutation stream of the reference's experiment loop, the one cohort draw
that does not need ``jax.random``.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, List

import numpy as np

from .compress import resolve_codec_cfg

# Width multiplier per complexity level (ref src/utils.py:114).
MODEL_SPLIT_RATE: Dict[str, float] = {"a": 1.0, "b": 0.5, "c": 0.25, "d": 0.125, "e": 0.0625}

CONTROL_KEYS = ("fed", "num_users", "frac", "data_split_mode", "model_split_mode",
                "model_mode", "norm", "scale", "mask")

#: the round engines (heterofl_tpu/config.py:47)
STRATEGIES = ("masked", "grouped", "sliced")

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
    "model_name": "resnet18",
    "optimizer_name": "Adam",
    "lr": 3.0e-4,
    "momentum": 0.9,
    "weight_decay": 5.0e-4,
    "scheduler_name": "None",
    "step_size": 1,
    "milestones": [100, 150],
    "factor": 0.5,
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
    "compute_dtype": "float32",
    # compressed aggregation (compress/): dense | int8 | signsgd | topk, and
    # the lossy codecs' error-feedback residual
    "wire_codec": "dense",
    "error_feedback": True,
    # sBN + Local/Global evaluation every this many rounds, and after the last
    "eval_interval": 1,
    "sampler": "perm",
    "data_dir": "./data",
    "output_dir": "./output",
    "synthetic": False,
    "synthetic_sizes": None,
    # 0 fresh, 1 full resume, 2 params and splits only (utils/checkpoint.py)
    "resume_mode": 0,
    # checkpoint generations kept (the live blob and keep - 1 older ones)
    "checkpoint_keep": 3,
    "use_tensorboard": False,
    "override": {},
}

#: keys of reference features this package does not port yet, each with the
#: value that turns its feature off (heterofl_tpu/config.py:57-355)
UNPORTED: Dict[str, Any] = {
    "world_size": 1,
    "data_placement": "replicated",
    "conv_impl": None,
    "scan_unroll": 1,
    "superstep_rounds": 1,
    "metrics_fetch_every": 1,
    "client_store": "eager",
    "schedule": None,
    "sample_horizon": None,
    "eval_cohort": None,
    "telemetry": "off",
    "ledger": "off",
    "arms": None,
    "watchdog": None,
    "quarantine": "off",
    "chaos_poison": None,
    "client_failure_rate": 0.0,
    # the grouped engine's per-level device partition needs several GPUs
    "level_placement": "span",
    "trace_dir": None,
    "profile_dir": None,
}
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
                f"yet (only {off!r} is)")
    checks = (("sampler", ("perm",)),
              ("compute_dtype", ("float32", None)))
    for key, ok in checks:
        if cfg.get(key, ok[0]) not in ok:
            raise NotImplementedError(
                f"cfg[{key!r}] = {cfg[key]!r} is not ported to heterofl_tpu_torch "
                f"yet (only {ok[0]!r} is)")
    resolve_codec_cfg(cfg)


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
    resolve_checkpoint_keep(cfg)
    return cfg


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

