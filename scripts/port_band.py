#!/usr/bin/env python3
"""The port's accuracy band against the JAX package over whole runs, on the CPU.

Both packages' federated drivers (``entry.common.FedExperiment.run``) train
the same configuration for ``--rounds`` rounds at each of ``--seeds``,
evaluated after every round: the same control string, the same synthetic
data (made from the seed), the same user split and cohorts (one
``default_rng(seed)`` stream in both, ``--sampler perm``), and the same
initial params -- the reference's ``model.init(fold_in(key(seed), 0))``,
loaded into the port's model through ``convert.params_from_jax``.  The
in-round draws (epoch orders, augmentation, an LM's corruption and
dropout) come from each package's own streams, so the runs agree only as
distributions: the band is over seeds, never per entry.

The runs (``--runs``, default all three):

* ``conv_sgd``: the conv/MNIST twin of the headline control
  ``1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1`` under its SGD (lr 1e-2,
  momentum 0.9, weight decay 5e-4, MultiStepLR at round 100);
* ``conv_adam``: the same under Adam at lr 1e-3;
* ``lm_sgd``: the masked LM, ``1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1``
  (one user a round) under its SGD (lr 1e-1), Global perplexity;
* ``lm_sgd_10``: the same LM at ten users a round
  (``1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1``): one user's round swings
  the global model so far that ``lm_sgd``'s band spans most of its mean
  and could not fail; ten users average it out.

Cuts, all for the CPU's time (30 minutes for the four runs, both packages,
three seeds): 20 rounds of the paper's 200; the conv net at widths 16/32
(the paper's 64/128/256/512), 2,000 synthetic train images (20 a user: 2
steps a local epoch) and 500 test images; the local epochs stay the
control's 5; the transformer at embedding 64, 2 heads, hidden 64, 2 layers,
bptt 16 (the paper's 256/8/512/4/64), dropout 0.2, on 20,000 synthetic
WikiText2 train tokens and 4,000 test tokens, its one local epoch.

The band, stated before the first run: at every round r the port's
seed-mean Global accuracy (LM: Global perplexity) lies within

    2 * sqrt(std_port(r)^2 + std_ref(r)^2) + floor

of the reference's seed mean, the standard deviations over the seeds
(``analysis.process.aggregate``), the floor 1.0 accuracy point (LM: 2.0
perplexity).  A run passes when every round does.  Each round also
records the band's width over the reference's mean (``rel_band``): a
port off by less than that share of the metric cannot fail the round.

Writes ``--out`` (default ``PORT_BAND.json`` at the repository root): each
run's config, cuts and band, every seed's curve from both packages, the
per-round aggregates and each round's verdict; prints one ``band`` line a
run.  Run from the repository root (no device needed)::

    JAX_PLATFORMS=cpu python3 scripts/port_band.py
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
LM_CONTROL = "1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
LM_OVERRIDE = {"bptt": 16, "transformer": {"embedding_size": 64, "num_heads": 2,
                                           "hidden_size": 64, "num_layers": 2, "dropout": 0.2}}
RUNS = {
    "conv_sgd": {"control": HEADLINE, "data_name": "MNIST", "model_name": "conv",
                 "sizes": {"train": 2000, "test": 500},
                 "override": {"conv": {"hidden_size": [16, 32]}},
                 "metric": "Global-Accuracy", "floor": 1.0},
    "conv_adam": {"control": HEADLINE, "data_name": "MNIST", "model_name": "conv",
                  "sizes": {"train": 2000, "test": 500},
                  "override": {"conv": {"hidden_size": [16, 32]}, "optimizer_name": "Adam",
                               "lr": 1e-3},
                  "metric": "Global-Accuracy", "floor": 1.0},
    "lm_sgd": {"control": LM_CONTROL, "data_name": "WikiText2", "model_name": "transformer",
               "sizes": {"train": 20000, "test": 4000}, "override": LM_OVERRIDE,
               "metric": "Global-Perplexity", "floor": 2.0},
    "lm_sgd_10": {"control": HEADLINE, "data_name": "WikiText2", "model_name": "transformer",
                  "sizes": {"train": 20000, "test": 4000}, "override": LM_OVERRIDE,
                  "metric": "Global-Perplexity", "floor": 2.0},
}


def argv_of(run: dict, rounds: int, out_dir: str) -> list:
    """The entry flags of one run: both packages take the same ones."""
    return ["--control_name", run["control"], "--data_name", run["data_name"],
            "--model_name", run["model_name"], "--synthetic", "1",
            "--synthetic_sizes", json.dumps(run["sizes"]), "--sampler", "perm",
            "--eval_interval", "1", "--output_dir", out_dir,
            "--override", json.dumps({"num_epochs": {"global": rounds}, **run["override"]})]


def reference_curve(argv: list, seed: int, metric: str):
    """The JAX package's run -> (its initial params as numpy, the metric a
    round)."""
    import jax
    import numpy as np

    from heterofl_tpu import config as RC
    from heterofl_tpu.entry import common as RE

    cfg = RE.cfg_from_args(RE.build_cli("band").parse_args(argv))
    exp = RE.FedExperiment(RC.process_control(cfg), seed)
    init = exp.model.init(jax.random.fold_in(exp.host_key, 0))
    init = {k: np.asarray(v) for k, v in init.items()}
    res = exp.run(metric, "max" if metric.endswith("Accuracy") else "min")
    return init, [float(v) for v in res["logger"].history[f"test/{metric}"]]


def port_curve(argv: list, seed: int, metric: str, init) -> list:
    """The port's run from the reference's initial params -> the metric a
    round."""
    from heterofl_tpu_torch.convert import params_from_jax
    from heterofl_tpu_torch.entry import common as PE

    cfg = PE.parse_cfg("band", "conv", "MNIST", argv + ["--device", "cpu"])
    exp = PE.FedExperiment(cfg, seed)
    exp.model.load_state_dict(params_from_jax(init, exp.perms))
    res = exp.run(metric, "max" if metric.endswith("Accuracy") else "min")
    return [float(v) for v in res["logger"].history[f"test/{metric}"]]


def band_of(name: str, run: dict, curves: dict, rounds: int) -> dict:
    """Each round's seed aggregates through ``analysis.process.aggregate``
    and the verdict of the stated band."""
    from heterofl_tpu_torch import config as PC
    from heterofl_tpu_torch.analysis.process import aggregate

    ctl = PC.parse_control_name(run["control"])
    metric, out = run["metric"], []
    for r in range(rounds):
        agg = {}
        for pkg, by_seed in curves.items():
            rows = [{"tag": f"{seed}_{name}", "seed": str(seed), "data_name": run["data_name"],
                     "subset": "label", "model_name": run["model_name"], **ctl,
                     "metrics": {metric: c[r]}} for seed, c in by_seed.items()]
            (group,) = aggregate(rows).values()
            agg[pkg] = {"mean": group["mean"][metric], "std": group["std"][metric],
                        "n_seeds": group["n_seeds"]}
        width = 2 * math.sqrt(agg["port"]["std"] ** 2 + agg["reference"]["std"] ** 2) \
            + run["floor"]
        gap = agg["port"]["mean"] - agg["reference"]["mean"]
        out.append({"round": r + 1, **agg, "gap": gap, "band": width,
                    "rel_band": width / abs(agg["reference"]["mean"]),
                    "inside": abs(gap) <= width})
    return {"rounds": out, "inside": all(r["inside"] for r in out),
            "worst": max(out, key=lambda r: abs(r["gap"]) - r["band"]),
            "widest_rel_band": max(r["rel_band"] for r in out)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", nargs="+", default=list(RUNS), choices=list(RUNS))
    parser.add_argument("--rounds", type=int, default=20)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--out", default=os.path.join(ROOT, "PORT_BAND.json"))
    args = parser.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = {"rounds": args.rounds, "seeds": args.seeds, "runs": {}}
    for name in args.runs:
        run = RUNS[name]
        curves = {"reference": {}, "port": {}}
        t0 = time.time()
        for seed in args.seeds:
            with tempfile.TemporaryDirectory(prefix="port_band_") as tmp:
                init, curves["reference"][seed] = reference_curve(
                    argv_of(run, args.rounds, os.path.join(tmp, "ref")), seed, run["metric"])
                curves["port"][seed] = port_curve(
                    argv_of(run, args.rounds, os.path.join(tmp, "port")), seed, run["metric"],
                    init)
            print(f"{name} seed {seed}: reference {curves['reference'][seed]}", flush=True)
            print(f"{name} seed {seed}: port {curves['port'][seed]}", flush=True)
        band = band_of(name, run, curves, args.rounds)
        result["runs"][name] = {"config": {k: run[k] for k in ("control", "data_name",
                                                                "model_name", "sizes",
                                                                "override")},
                                "metric": run["metric"], "floor": run["floor"],
                                "curves": {pkg: {str(s): c for s, c in by.items()}
                                           for pkg, by in curves.items()},
                                "cpu_seconds": time.time() - t0, **band}
        worst = band["worst"]
        print("band", json.dumps({"run": name, "inside": band["inside"],
                                  "worst_round": worst["round"], "gap": worst["gap"],
                                  "band": worst["band"],
                                  "widest_rel_band": band["widest_rel_band"],
                                  "seconds": result["runs"][name]["cpu_seconds"]}), flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
