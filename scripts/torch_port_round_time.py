#!/usr/bin/env python3
"""Round time of the port's federated main path, in turns between
checkouts on one GPU.

    python3 scripts/torch_port_round_time.py --roots OLD . . OLD \\
        --out round_time.json

Each root (a checkout of the repository) runs in a process of its own, in
the order given: the headline control on full-width ResNet-18 and
synthetic CIFAR10 at its real size through that checkout's
``FedExperiment.run`` (the loop of ``train_classifier_fed``), ``--rounds``
rounds at ``--local-epochs``, ``pallas_norm=1``, into a fresh temporary
``output_dir``.  The evaluation is stubbed out in every checkout (it is
not what is compared).  Per round it records the seconds of
``train_round``'s own window (the round time a user reads in the log) and
the wall time from one round's start to the next's (a checkpoint write
included, where the checkout writes one).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"


def one(root: str, rounds: int, local_epochs: int) -> dict:
    """One checkout's run, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from heterofl_tpu_torch.entry import common, train_classifier_fed

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_round_time: no CUDA device")
    starts = []
    train_round = common.FedExperiment.train_round

    def timed(self, *args, **kwargs):
        torch.cuda.synchronize()
        starts.append(time.time())
        return train_round(self, *args, **kwargs)

    common.FedExperiment.train_round = timed
    common.FedExperiment.evaluate = lambda self, P, epoch, *a, **k: {}
    with tempfile.TemporaryDirectory(prefix="round_time_") as out:
        argv = ["--control_name", HEADLINE, "--synthetic", "1", "--synthetic_sizes",
                json.dumps({"train": 50000, "test": 10000}), "--pallas_norm", "1",
                "--output_dir", out, "--override",
                json.dumps({"num_epochs": {"global": rounds, "local": local_epochs}})]
        (result,) = train_classifier_fed.main(argv)
        torch.cuda.synchronize()
        starts.append(time.time())
    hist = result["history"]
    return {"root": root, "round_seconds": [r["seconds"] for r in hist],
            "wall_seconds": [b - a for a, b in zip(starts, starts[1:])],
            "checkpoint_seconds": [r.get("checkpoint_seconds") for r in hist]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="+", required=True, help="checkouts, in run order")
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--local-epochs", type=int, default=1)
    parser.add_argument("--out", default=None, help="write the runs here as JSON")
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print(json.dumps(one(args.one, args.rounds, args.local_epochs)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in args.roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                              "--rounds", str(args.rounds), "--local-epochs",
                              str(args.local_epochs), "--roots", root],
                             capture_output=True, text=True, check=True).stdout
        run = json.loads(out.strip().splitlines()[-1])
        steady = run["round_seconds"][1:]  # the first round warms cuDNN and the allocator
        walls = run["wall_seconds"][1:]
        print(f"{root}: train_round {', '.join(f'{s:.3f}' for s in run['round_seconds'])} s "
              f"(median of rounds 2-{args.rounds}: {statistics.median(steady):.3f}); whole round "
              f"{', '.join(f'{s:.3f}' for s in run['wall_seconds'])} s (median "
              f"{statistics.median(walls):.3f})", flush=True)
        runs.append(run)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rounds": args.rounds, "local_epochs": args.local_epochs,
                       "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
