"""Evaluation entry points (the reference's ``test_*.py`` scripts).

Port of ``heterofl_tpu/entry/evaluate.py``: load the best checkpoint,
stage the data split it holds, recalibrate BN (sBN) over the train set,
evaluate Local and Global (the centralised baseline: the test set; a
masked LM: Global only), and write the result bundle
``output_dir/result/{tag}.pkl``.  A blob stores the epoch to resume at,
so the evaluation runs at the one before, the epoch it was logged at: an
LM's corruption draws are seeded from it and reproduce the logged value.
The checkpoint may come from either package (federated blobs hold the
reference's layout)."""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

from .. import config as C
from ..convert import params_from_jax
from ..utils import Logger, checkpoint_path, load_checkpoint, summarize_sums
from .central import CentralExperiment
from .common import FedExperiment, parse_cfg


def _write_bundle(cfg: Dict[str, Any], tag: str, result: Dict[str, Any]) -> str:
    out_path = os.path.join(cfg["output_dir"], "result", f"{tag}.pkl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    return out_path


def _load(cfg: Dict[str, Any], tag: str, load_tag: str) -> Dict[str, Any]:
    path = checkpoint_path(cfg["output_dir"], tag, load_tag)
    if not os.path.exists(path):
        raise SystemExit(f"Not exists model tag: {tag} (expected checkpoint at {path}) "
                         f"-- train first")
    return load_checkpoint(path)


def _logged_epoch(blob: Dict[str, Any]) -> int:
    """The epoch a blob was evaluated at: it stores the one to resume at."""
    return max(int(blob.get("epoch") or 1) - 1, 0)


def evaluate_experiment(cfg: Dict[str, Any], seed: int, load_tag: str = "best"
                        ) -> Dict[str, Any]:
    """sBN and Local/Global of one seed's ``load_tag`` checkpoint -> the
    result bundle ``{cfg, epoch, logger_history, train_history}``."""
    if cfg["control"].get("data_split_mode") == "none":
        return _evaluate_central(cfg, seed, load_tag)
    exp = FedExperiment(cfg, seed)
    blob = _load(cfg, exp.tag, load_tag)
    P = exp.engine.flatten(params_from_jax(blob["params"], exp.perms))
    exp.stage(blob["data_split"], blob["label_split"])
    logger = Logger(os.path.join(cfg["output_dir"], "runs", f"test_{exp.tag}"),
                    use_tensorboard=bool(cfg.get("use_tensorboard")))
    logger.safe(True)
    # a blob stores the epoch to resume at; it was evaluated the one before
    exp.evaluate(P, _logged_epoch(blob), logger)
    logger.safe(False)
    result = {"cfg": {k: v for k, v in exp.cfg.items() if k != "vocab"},
              "epoch": blob.get("epoch"),
              "logger_history": dict(logger.history),
              "train_history": blob.get("logger_history", {})}
    print(f"saved result bundle: {_write_bundle(cfg, exp.tag, result)}", flush=True)
    return result


def _evaluate_central(cfg: Dict[str, Any], seed: int, load_tag: str) -> Dict[str, Any]:
    """The centralised baseline's checkpoint: sBN (vision), then the test
    set -> ``{cfg, epoch, metrics, train_history}``."""
    exp = CentralExperiment(cfg, seed)
    blob = _load(exp.cfg, exp.tag, load_tag)
    params = {k: v.to(exp.device)
              for k, v in params_from_jax(blob["params"], exp.perms).items()}
    _, g = exp.evaluate(params, _logged_epoch(blob))
    named = summarize_sums(g, prefix="", kind=exp.kind)
    result = {"cfg": {k: v for k, v in exp.cfg.items() if k != "vocab"},
              "epoch": blob.get("epoch"), "metrics": named,
              "train_history": blob.get("logger_history", {})}
    print(f"saved result bundle: {_write_bundle(exp.cfg, exp.tag, result)}  {named}",
          flush=True)
    return result


def run_test_main(description: str, model_default: str, data_default: str,
                  argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Parse flags, loop the seeds, evaluate each seed's best checkpoint."""
    cfg = parse_cfg(description, model_default, data_default, argv)
    if C.launched_world_size() > 1:
        raise NotImplementedError(
            "the test entries evaluate a checkpoint on one rank: launch them without torchrun "
            "(ROADMAP Queue 1 item 5)")
    return [evaluate_experiment(cfg, cfg["init_seed"] + i) for i in range(cfg["num_experiments"])]
