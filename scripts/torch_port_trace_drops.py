#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace of a replayed local epoch loses the
card's kernel records.

``chip_smoke.py`` counts the hand-written kernels of a replayed epoch by
name in a trace and holds the counts to the captured step's launches times
the replays.  This script traces the headline experiment's level-a epoch
(full-width ResNet-18, batch 10, replayed from its captured step) many
times, in float32 and in bfloat16, and prints for each precision how many
traces counted other than the captured launches x replays, and how many of
the card's records each such trace held against a whole one.  Run from the
repository root on a machine with a CUDA device::

    python3 scripts/torch_port_trace_drops.py --traces 100 --out trace_drops.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=100, help="traces of each precision")
    ap.add_argument("--out", default=None, help="write the counts here as JSON")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from heterofl_tpu_torch.entry.common import FedExperiment, parse_cfg
    from heterofl_tpu_torch.fed.core import round_seed
    from heterofl_tpu_torch.ops import _build
    from heterofl_tpu_torch.parallel import client_seed

    if not torch.cuda.is_available():
        print("torch_port_trace_drops: this script needs a CUDA device", file=sys.stderr)
        return 2
    _build.load()
    dev = torch.device("cuda")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
    out = {"device": smi.strip(), "traces": args.traces, "runs": {}}
    print(out["device"], flush=True)
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            cfg = parse_cfg("trace drops", "resnet18", "CIFAR10", cs.fed_argv(
                os.path.join(tmp, dtype), "dense", 1, cs.SS_ROUNDS, "--superstep_rounds",
                str(cs.SS_ROUNDS), "--compute_dtype", dtype))
            exp = FedExperiment(cfg, cfg["init_seed"])
            exp.stage(*exp.make_splits())
            eng, data = exp.engine, exp.train_data
            P = eng.flatten(exp.model.params())
            cseed = client_seed(round_seed(0, 1), 0)
            lr = torch.full((), 0.1, dtype=torch.float32, device=dev)

            def replayed_epoch():
                step, st = eng.client_step(1.0, P, data)
                eng.stage_client(st, P, 1.0, 0, data, cseed)
                st["lr"].copy_(lr)
                for _ in range(st["steps"]):
                    step.replay()

            replayed_epoch()
            torch.cuda.synchronize()
            step, st = eng.client_step(1.0, P, data)
            want = {k: v * st["steps"] for c in step.launches for k, v in c.items()}
            records, short = [], []
            for i in range(args.traces):
                prof, _ = cs.trace(replayed_epoch)
                got = cs.traced_kernels(prof)
                records.append(len(cs.device_events(prof)))
                if any(got[k] != want.get(k, 0) for k in cs.KERNEL_OF):
                    short.append({"trace": i, "counted": {k: v for k, v in got.items() if v},
                                  "records": records[-1]})
            whole = max(records)
            out["runs"][dtype] = {"want": want, "records_most": whole, "short": short}
            print(f"{dtype}: {len(short)} of {args.traces} traces counted other than the "
                  f"captured launches x replays {want}; a whole trace holds {whole} device "
                  f"records; the short ones: {short}", flush=True)
            del exp, eng, data, P, step, st
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
