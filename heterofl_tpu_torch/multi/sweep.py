"""Sweep front end: a grid -> arm batches x structural launches -> runs.

Port of ``heterofl_tpu/multi/sweep.py`` (the reference's messages).
``python -m heterofl_tpu_torch.multi.sweep --grid '{"seed": [0, 1, 2, 3],
"lr": [0.1, 0.03], "wire_codec": ["dense", "int8"]}'`` partitions the grid
into

* **arm axes** -- ``seed`` (alias ``init_seed``) and ``lr``: knobs an arm
  varies inside one superstep (its stream root, its scale over the shared
  learning-rate schedule); their cross product is the arms, cut into
  launches of at most ``--max_arms``;
* **structural axes** -- every other key (``wire_codec``, ``strategy``,
  ``superstep_rounds``, ...): each combination a launch of its own.

Each launch runs :class:`~..entry.common.ArmsExperiment` under its own
``{output_dir}/launch{i:03d}`` (launches share model tags, so the
subdirectory keeps their checkpoints, logs and resume blobs apart), on
``--device`` (``cuda`` unless ``--device cpu``).  ``--dry_run 1`` prints
the partition and runs nothing.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import MAX_ARMS

#: grid keys that become per-arm variation inside one program; everything
#: else in the grid is structural (one launch per value combination)
ARM_AXES = ("seed", "init_seed", "lr")


def partition_grid(grid: Dict[str, Sequence[Any]], max_arms: int = 8
                   ) -> List[Tuple[Dict[str, Any], List[Tuple[Optional[int],
                                                              Optional[float]]]]]:
    """Partition a grid spec into ``(structural overrides, arm batch)``
    launches.

    Each arm batch is a list of ``(seed, lr)`` pairs (either element may
    be ``None`` when the grid has no such axis) -- the cross product of
    the arm axes, chunked to ``max_arms``.  Structural launches are the
    cross product of every other key.  Deterministic order (sorted keys,
    given value order), so a sweep is resumable by launch index."""
    if not isinstance(grid, dict) or not grid:
        raise ValueError(f"Not valid grid: {grid!r} (a non-empty dict of "
                         f"cfg-key -> list of values)")
    if not 1 <= max_arms <= MAX_ARMS:
        raise ValueError(f"Not valid max_arms: {max_arms!r} (1..{MAX_ARMS})")
    grid = {k: list(v) for k, v in grid.items()}
    for k, v in grid.items():
        if not v:
            raise ValueError(f"Not valid grid axis {k!r}: empty value list")
    if "seed" in grid and "init_seed" in grid:
        raise ValueError("grid names both 'seed' and 'init_seed' (aliases "
                         "of the same arm axis): pick one")
    seeds = grid.pop("seed", None) or grid.pop("init_seed", None) or [None]
    lrs = grid.pop("lr", [None])
    for s in seeds:
        if s is not None and (not isinstance(s, int) or isinstance(s, bool)
                              or s < 0):
            raise ValueError(f"Not valid grid seed: {s!r} (a non-negative "
                             f"int)")
    for lr in lrs:
        if lr is not None and (not isinstance(lr, (int, float))
                               or isinstance(lr, bool) or not lr > 0):
            raise ValueError(f"Not valid grid lr: {lr!r} (a positive "
                             f"number)")
    arm_combos = [(s, lr) for s in seeds for lr in lrs]
    keys = sorted(grid)
    structural = [dict(zip(keys, vals))
                  for vals in itertools.product(*(grid[k] for k in keys))] \
        if keys else [{}]
    launches = []
    for struct in structural:
        for i in range(0, len(arm_combos), max_arms):
            launches.append((struct, arm_combos[i:i + max_arms]))
    return launches


def launch_cfg(base_cfg: Dict[str, Any], idx: int, struct: Dict[str, Any],
               batch: List[Tuple[Optional[int], Optional[float]]]
               ) -> Dict[str, Any]:
    """The processed cfg of launch ``idx``: structural overrides applied,
    the arm batch resolved, and the launch's OWN output root
    (``{output_dir}/launch{idx:03d}``).  The subdirectory is load-bearing:
    ``make_model_tag`` ignores structural keys, so sibling launches share
    checkpoint/log tags -- a flat output_dir would clobber each other's
    per-arm checkpoints and cross-resume from the wrong launch's blob."""
    from .. import config as C
    cfg = copy.deepcopy(base_cfg)
    for k, v in struct.items():
        cfg[k] = v  # keys validated up front, before any launch ran
    cfg["output_dir"] = os.path.join(base_cfg.get("output_dir") or ".",
                                     f"launch{idx:03d}")
    cfg = C.process_control(cfg)
    cfg["arms"] = arms_cfg_of(cfg, batch)
    return cfg


def arms_cfg_of(cfg: Dict[str, Any],
                batch: List[Tuple[Optional[int], Optional[float]]]
                ) -> Dict[str, Any]:
    """The ``cfg['arms']`` dict of one arm batch AGAINST a processed cfg:
    seeds pass through (``None`` = the identity arm -- a pure-LR sweep
    shares the base stream), LR values become multiplicative scales over
    the launch's resolved ``cfg['lr']`` (the shared schedule shape)."""
    base_lr = float(cfg["lr"])
    return {"count": len(batch),
            "seeds": [s for s, _ in batch],
            "lr_scales": [1.0 if lr is None else float(lr) / base_lr
                          for _, lr in batch]}


def describe_launch(idx: int, struct: Dict[str, Any],
                    batch: List[Tuple[Optional[int], Optional[float]]]) -> str:
    arms = ", ".join(f"(seed={s}, lr={lr})" for s, lr in batch)
    return (f"launch {idx}: structural={struct or '{}'} "
            f"E={len(batch)} arms=[{arms}]")


def main(argv: Optional[List[str]] = None) -> int:
    # the entry layer (torch, the engines) only when the front end runs
    from .. import config as C
    from .. import resolve_device
    from ..entry.common import ArmsExperiment, build_cli, cfg_from_args

    parser = build_cli("HeteroFL experiment-arms sweep: E grid cells per "
                       "superstep")
    parser.add_argument("--grid", default=None, type=str,
                        help="JSON grid spec: {cfg_key: [values, ...]}; "
                             "'seed'/'init_seed' and 'lr' become arms, "
                             "everything else structural launches")
    parser.add_argument("--grid_file", default=None, type=str,
                        help="path to a JSON grid spec (overrides --grid)")
    parser.add_argument("--max_arms", default=8, type=int,
                        help=f"arms per launch (1..{MAX_ARMS})")
    parser.add_argument("--dry_run", default=0, type=int,
                        help="1 = print the partition and exit")
    parser.add_argument("--pivot_metric", default="Global-Accuracy", type=str)
    parser.add_argument("--pivot_mode", default="max", type=str)
    args = parser.parse_args(argv)
    if args.grid_file:
        with open(args.grid_file) as f:
            grid = json.load(f)
    elif args.grid:
        grid = json.loads(args.grid)
    else:
        parser.error("--grid or --grid_file is required")
    base_cfg = cfg_from_args(args)
    resolve_device(base_cfg)
    # structural keys validated up front (and under --dry_run): a typo
    # fails before the first launch runs, not after some completed
    for k in grid if isinstance(grid, dict) else ():
        if k not in ARM_AXES and k not in C.DEFAULT_CFG:
            raise ValueError(f"Not valid structural grid key: {k!r} "
                             f"(a DEFAULT_CFG key; control-string "
                             f"fields go through --control_name)")
    launches = partition_grid(grid, max_arms=args.max_arms)
    for i, (struct, batch) in enumerate(launches):
        print(describe_launch(i, struct, batch))
    if args.dry_run:
        return 0
    for i, (struct, batch) in enumerate(launches):
        cfg = launch_cfg(base_cfg, i, struct, batch)
        print(f"sweep: running {describe_launch(i, struct, batch)} -> "
              f"{cfg['output_dir']}")
        exp = ArmsExperiment(cfg, cfg["init_seed"])
        exp.run(args.pivot_metric, args.pivot_mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
