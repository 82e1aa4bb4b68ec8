#!/usr/bin/env python3
"""bfloat16 against float32 over a few rounds of the headline control.

Runs ``train_classifier_fed`` (the PyTorch/CUDA port) on the headline
control ``1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1`` at full width
(ResNet-18, synthetic CIFAR10 at 25,000 train images, batch 10, one local
epoch) for ``--rounds`` rounds as supersteps of two, evaluated after every
round, once in float32 and once with ``--compute_dtype bfloat16``, for each
seed in ``--seeds`` (``init_seed``: the init, the data and the cohorts).
Prints each round's train loss and accuracy and Local / Global accuracy,
then the final train loss of each run, and checks that bf16's final train
loss lies within ``--band`` of float32's for each seed.  Run from the
repository root on a machine with a CUDA device::

    python3 scripts/torch_port_band.py --out band.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
SIZES = {"train": 25000, "test": 10000}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--band", type=float, default=0.05,
                    help="the most bf16's final train loss may differ from float32's")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from heterofl_tpu_torch.entry import train_classifier_fed

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0], flush=True)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="band_") as tmp:
        for seed in (int(s) for s in args.seeds.split(",")):
            for dtype in ("float32", "bfloat16"):
                argv_run = ["--device", args.device, "--control_name", HEADLINE, "--synthetic",
                            "1", "--synthetic_sizes", json.dumps(SIZES), "--pallas_norm", "1",
                            "--init_seed", str(seed), "--compute_dtype", dtype,
                            "--superstep_rounds", "2", "--eval_interval", "1",
                            "--output_dir", os.path.join(tmp, f"{dtype}_{seed}"), "--override",
                            json.dumps({"num_epochs": {"global": args.rounds, "local": 1}})]
                t0 = time.time()
                (result,) = train_classifier_fed.main(argv_run)
                secs = time.time() - t0
                hist = [{k: r.get(k) for k in ("epoch", "loss", "accuracy", "Local-Accuracy",
                                                 "Global-Accuracy", "seconds", "eval_seconds")}
                        for r in result["history"]]
                runs[f"{dtype} seed {seed}"] = {"seconds": secs, "history": hist}
                for r in hist:
                    print(f"band {dtype} seed {seed} round {r['epoch']}: train loss "
                          f"{r['loss']:.6f} accuracy {r['accuracy']:.4f}%; Local accuracy "
                          f"{r['Local-Accuracy']:.4f}%, Global accuracy "
                          f"{r['Global-Accuracy']:.4f}%", flush=True)
                print(f"band {dtype} seed {seed}: {secs:.1f} s host clock, the whole run",
                      flush=True)
    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        f32 = runs[f"float32 seed {seed}"]["history"][-1]["loss"]
        b16 = runs[f"bfloat16 seed {seed}"]["history"][-1]["loss"]
        inside = abs(b16 - f32) <= args.band
        ok &= inside
        print(f"band seed {seed}: final train loss float32 {f32:.6f}, bf16 {b16:.6f}, "
              f"|diff| {abs(b16 - f32):.6f} (band {args.band:g}): {'held' if inside else 'missed'}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
