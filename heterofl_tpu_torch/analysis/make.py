"""Experiment grid generator.

Port of ``heterofl_tpu/analysis/make.py``: the control strings of a model
family (singles a1..e1, the multi-level combinations, the 9-step
two-level interpolation pairs; the ablation grids over norm, scale and
mask) and a bash script that runs them through the port's entries
(``python -m heterofl_tpu_torch.entry.<run>_<family>[_fed]``).  The
reference's TPU waves are re-expressed for GPUs as the original HeteroFL
``make.py`` does (its :31, :88-98): ``--gpus 0,1,...`` round-robins
``CUDA_VISIBLE_DEVICES`` over the jobs, with a ``wait`` every ``--round``
jobs; one GPU (``0``) is the default.
"""

from __future__ import annotations

import argparse
import itertools
from typing import List, Sequence

LEVELS = ["a", "b", "c", "d", "e"]


def single_modes(levels: List[str] = LEVELS) -> List[str]:
    return [x + "1" for x in levels]


def combination_modes(levels: List[str] = LEVELS) -> List[str]:
    """All >= 2-level equal-proportion combinations (ref make.py:57-61)."""
    singles = single_modes(levels)
    out: List[str] = []
    for i in range(1, len(singles) + 1):
        out.extend("-".join(x) for x in itertools.combinations(singles, i))
    return out[len(singles):]


def interp_modes(levels: List[str] = LEVELS) -> List[str]:
    """Two-level proportion sweeps ``xi-y(10-i)``, i = 1..9 (ref make.py:62-66)."""
    out = []
    for i in range(1, 10):
        for j in range(len(levels)):
            for k in range(j + 1, len(levels)):
                out.append(f"{levels[j]}{i}-{levels[k]}{10 - i}")
    return out


MODEL_TABLE = {
    "conv": ("MNIST", "classifier"),
    "resnet18": ("CIFAR10", "classifier"),
    "transformer": ("WikiText2", "transformer"),
}


def build_controls(model: str, fed: int, data_split_mode: str, ablation: bool = False
                   ) -> List[str]:
    """Control strings of one model family (ref make.py:67-82 and
    make_ablation.py:55-85)."""
    if ablation:
        levels = ["a", "e"]
        combo = combination_modes(levels)
        norm_1, norm_2 = ["bn", "none"], ["in", "ln", "gn"]
        if data_split_mode == "iid":
            blocks = [
                [["1"], ["100"], ["0.1"], [data_split_mode], ["fix"], single_modes(levels),
                 norm_2 + norm_1, ["1"], ["1"]],
                [["1"], ["100"], ["0.1"], [data_split_mode], ["dynamic"], combo, norm_2,
                 ["1"], ["1"]],
                [["1"], ["100"], ["0.1"], [data_split_mode], ["dynamic"], combo, norm_1,
                 ["0", "1"], ["1"]],
            ]
        else:
            blocks = [
                [["1"], ["100"], ["0.1"], [data_split_mode], ["fix"], single_modes(levels),
                 norm_2, ["1"], ["1"]],
                [["1"], ["100"], ["0.1"], [data_split_mode], ["fix"], single_modes(levels),
                 norm_1, ["1"], ["0", "1"]],
                [["1"], ["100"], ["0.1"], [data_split_mode], ["dynamic"], combo, norm_2,
                 ["1"], ["1"]],
            ]
    elif fed == 0:
        blocks = [[["0"], ["1"], ["1"], [data_split_mode], ["fix"], single_modes(), ["bn"],
                   ["1"], ["1"]]]
    else:
        blocks = [
            [["1"], ["100"], ["0.1"], [data_split_mode], ["fix"], single_modes(), ["bn"],
             ["1"], ["1"]],
            [["1"], ["100"], ["0.1"], [data_split_mode], ["dynamic"], combination_modes(),
             ["bn"], ["1"], ["1"]],
            [["1"], ["100"], ["0.1"], [data_split_mode], ["fix"], interp_modes(), ["bn"],
             ["1"], ["1"]],
        ]
    out: List[str] = []
    for b in blocks:
        out.extend("_".join(x) for x in itertools.product(*b))
    return out


def make_script(run: str, model: str, fed: int, data_split_mode: str, *,
                init_seed: int = 0, num_experiments: int = 1, experiment_step: int = 1,
                resume_mode: int = 0, round_size: int = 1, gpus: Sequence[str] = ("0",),
                ablation: bool = False, synthetic: bool = False,
                modes: Sequence[str] = (), extra_args: str = "") -> str:
    """The bash script of the grid: one job a (seed, control), job ``j`` on
    ``CUDA_VISIBLE_DEVICES=gpus[j % len(gpus)]``, a ``wait`` after every
    ``round_size`` jobs.  ``modes`` keeps only those model modes (the
    control's 6th field); ``extra_args`` is appended to every job."""
    data_name, family = MODEL_TABLE[model]
    suffix = "_fed" if fed == 1 else ""
    module = f"heterofl_tpu_torch.entry.{run}_{family}{suffix}"
    controls = build_controls(model, fed, data_split_mode if fed else "none", ablation)
    if modes:
        want = set(modes)
        controls = [c for c in controls if c.split("_")[5] in want]
    gpus = list(gpus) or ["0"]
    seeds = list(range(init_seed, init_seed + num_experiments, experiment_step))
    lines = ["#!/bin/bash"]
    k = 0
    extra = " --synthetic 1" if synthetic else ""
    if extra_args:
        extra += " " + extra_args.strip()
    for seed in seeds:
        for ctl in controls:
            lines.append(
                f"CUDA_VISIBLE_DEVICES={gpus[k % len(gpus)]} python -m {module} "
                f"--data_name {data_name} --model_name {model} --init_seed {seed} "
                f"--num_experiments {experiment_step} --resume_mode {resume_mode} "
                f"--control_name {ctl}{extra} &")
            if k % round_size == round_size - 1:
                lines[-1] = lines[-1][:-2]
                lines.append("wait")
            k += 1
    if lines[-1] != "wait":
        lines.append("wait")
    return "\n".join(lines) + "\n"


def main(argv=None):
    """``python -m heterofl_tpu_torch.analysis.make [--gpus 0,1] ...``:
    writes ``./{run}_{model}_{split}[_ablation].sh`` and prints it."""
    parser = argparse.ArgumentParser(description="experiment grid generator")
    parser.add_argument("--run", default="train", type=str)
    parser.add_argument("--model", default="resnet18", type=str)
    parser.add_argument("--fed", default=1, type=int)
    parser.add_argument("--init_seed", default=0, type=int)
    parser.add_argument("--round", default=1, type=int,
                        help="jobs between two waits (the jobs run side by side)")
    parser.add_argument("--experiment_step", default=1, type=int)
    parser.add_argument("--num_experiments", default=1, type=int)
    parser.add_argument("--resume_mode", default=0, type=int)
    parser.add_argument("--data_split_mode", default="iid", type=str)
    parser.add_argument("--gpus", default="0", type=str,
                        help="comma-separated GPU ids the jobs round-robin over")
    parser.add_argument("--ablation", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--modes", default="", type=str,
                        help="comma-separated model_mode whitelist (e.g. 'a1,b1,a5-b5')")
    parser.add_argument("--extra", default="", type=str,
                        help="verbatim flags appended to every job")
    args = parser.parse_args(argv)
    s = make_script(args.run, args.model, args.fed, args.data_split_mode,
                    init_seed=args.init_seed, num_experiments=args.num_experiments,
                    experiment_step=args.experiment_step, resume_mode=args.resume_mode,
                    round_size=args.round, gpus=[g for g in args.gpus.split(",") if g],
                    ablation=args.ablation, synthetic=args.synthetic,
                    modes=[m for m in args.modes.split(",") if m], extra_args=args.extra)
    name = f"{args.run}_{args.model}_{args.data_split_mode if args.fed else 'none'}"
    if args.ablation:
        name += "_ablation"
    path = f"./{name}.sh"
    with open(path, "w") as f:
        f.write(s)
    print(s)
    print(f"# written to {path}")
    return s


if __name__ == "__main__":
    main()
