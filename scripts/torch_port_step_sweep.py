#!/usr/bin/env python3
"""A replayed local step of the PyTorch/CUDA port under each precision and
convolution lowering, in one process.

For each of levels a and e (width rates 1 and 0.0625), the masked engine's
step and the grouped engine's batched step of two clients (``--clients
2``), and each of {float32, bfloat16} x {direct, im2col}, runs
``scripts/torch_port_profile.py --graph`` and prints one line: the
replayed step's host-clock ms, kernels a step, the device's busy share and
device ms a step by bucket (convolutions, cuDNN's layout transposes,
matmuls, the port's BN and SGD kernels, the rest).  Run from the
repository root on a machine with a CUDA device::

    python3 scripts/torch_port_step_sweep.py --out step_sweep.json

``--device cpu --samples 20 --repeats 1`` rehearses it on the CPU (no
device numbers come out of that).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [(dtype, impl) for dtype in ("float32", "bfloat16") for impl in ("direct", "im2col")]
CELLS = [("masked", 0, 1.0), ("masked", 0, 0.0625), ("grouped G 2", 2, 1.0),
         ("grouped G 2", 2, 0.0625)]
BUCKETS = ("convolution", "cudnn layout transposes", "matmul", "port bn kernels",
           "port sgd kernel", "other")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    sys.path.insert(0, ROOT)
    import torch
    import torch_port_profile

    from heterofl_tpu_torch.parallel import step_graph

    rows = []
    for engine, clients, width in CELLS:
        for dtype, impl in CONFIGS:
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            step_graph.reset_stats()
            with tempfile.TemporaryDirectory(prefix="step_sweep_") as tmp:
                path = os.path.join(tmp, "one.json")
                torch_port_profile.main(["--device", args.device, "--samples",
                                         str(args.samples), "--repeats", str(args.repeats),
                                         "--graph", "--width", str(width), "--clients",
                                         str(clients), "--compute_dtype", dtype, "--conv_impl",
                                         impl, "--out", path])
                with open(path) as f:
                    one = json.load(f)
            prof = one["profile"]
            steps = prof["steps"]
            row = {"engine": engine, "width": width, "compute_dtype": dtype, "conv_impl": impl,
                   "replayed_ms": one["ms_per_step"]["replayed steps"]["median"],
                   "eager_ms": one["ms_per_step"]["eager"]["median"],
                   "kernels_per_step": prof["kernel_launches_per_step"],
                   "busy_share": prof["device_busy_share"],
                   "device_ms_by_bucket": {b: prof["buckets"].get(b, {}).get("device_ms", 0.0)
                                           / steps for b in BUCKETS},
                   "pool_mb": one["graph_stats"]["pool_bytes"] / 1e6,
                   "card": one.get("nvidia_smi")}
            rows.append(row)
            print(f"sweep {engine} width {width:g} {dtype} {impl}: replayed "
                  f"{row['replayed_ms']:.3f} ms a step (host clock; eager "
                  f"{row['eager_ms']:.3f}), {row['kernels_per_step']:.1f} kernels a step, busy "
                  f"{100 * row['busy_share']:.1f}%, graph pools {row['pool_mb']:.1f} MB; device "
                  f"ms a step: " + ", ".join(f"{b} {v:.3f}" for b, v in
                                              row["device_ms_by_bucket"].items()), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
