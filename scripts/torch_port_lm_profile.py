#!/usr/bin/env python3
"""Where a masked-LM training step of the PyTorch/CUDA port spends its time.

The full-width transformer of ``1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1``
(E 256, 8 heads, FFN 512, 4 layers, bptt 64, the synthetic vocabulary of
512 tokens) on two steps:

* the federated local step: one client's token row in ``[1, 64]`` windows
  through ``RoundEngine.local_train_lm`` (the fused-SGD kernel);
* the centralised step: ``[100, 64]`` windows through
  ``CentralEngine.train_epoch`` (the per-tree update).

For each: the step time on the host clock around ``synchronize`` (median
of ``--repeats`` runs of ``--steps`` steps, after a warm-up run), then a
``torch.profiler`` trace of one run: kernel launches per step, device time
per step by kernel name and bucket, and the device's busy share of the
run's wall time.  Run from the repository root on a machine with a CUDA
device::

    python3 scripts/torch_port_lm_profile.py --out lm_profile.json

``--device cpu --steps 2 --repeats 1`` rehearses the control flow on the
CPU (no device numbers come out of that).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_CONTROL = "1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
CENTRAL = "1_1_1_none_fix_a1_bn_1_1"
# kernel-name fragments of each bucket of device time, checked in order
BUCKETS = [("port sgd kernel", ("sgd_norm_partial", "sgd_apply")),
           ("matmul", ("gemm", "xmma", "sm90_", "cutlass", "matmul")),
           ("softmax", ("softmax",)),
           ("reduction", ("reduce",)),
           ("copy, cat, index", ("copy", "cat", "index", "gather", "scatter"))]


def bucket_of(name: str) -> str:
    low = name.lower()
    for label, frags in BUCKETS:
        if any(f in low for f in frags):
            return label
    return "other elementwise"


def cfg_of(control: str):
    from heterofl_tpu_torch import config as C

    cfg = C.default_cfg()
    cfg.update(control=C.parse_control_name(control), data_name="WikiText2",
               model_name="transformer")
    cfg = C.process_control(cfg)
    cfg["num_tokens"] = cfg["classes_size"] = 512
    return cfg


def measure(torch, dev, run, steps: int, repeats: int):
    """``run(seed)`` trains ``steps`` steps -> the median ms a step and a
    profile of one more run."""
    from torch.profiler import ProfilerActivity, profile

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    run(0)  # warm-up: kernel build, cuBLAS handles, allocator
    times = []
    for rep in range(repeats):
        sync()
        t0 = time.perf_counter()
        run(rep + 1)
        sync()
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(99)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and evt.device_type is not None and "CUDA" in str(evt.device_type):
            rows.append({"name": evt.key, "calls": evt.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    buckets = {}
    for r in rows:
        b = buckets.setdefault(bucket_of(r["name"]), {"device_ms": 0.0, "launches": 0})
        b["device_ms"] += r["device_ms"]
        b["launches"] += r["calls"]
    return {"ms_per_step": {"median": statistics.median(times), "all": times},
            "profile_wall_ms_per_step": wall / steps, "device_busy_ms_per_step": busy / steps,
            "device_busy_share": busy / wall if wall else 0.0,
            "kernel_launches_per_step": sum(r["calls"] for r in rows) / steps,
            "buckets": {k: {"device_ms_per_step": v["device_ms"] / steps,
                            "launches_per_step": v["launches"] / steps}
                        for k, v in buckets.items()},
            "top": rows[:20]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40, help="steps a timed run")
    ap.add_argument("--repeats", type=int, default=5, help="timed runs per step kind")
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from heterofl_tpu_torch import resolve_device
    from heterofl_tpu_torch.data import batchify, bptt_windows, stack_windows, synthetic_lm
    from heterofl_tpu_torch.entry.central import CentralEngine
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import RoundEngine

    dev = resolve_device({"device": args.device})
    out = {"device": str(dev), "steps": args.steps}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(out["nvidia_smi"], flush=True)
    cfg = cfg_of(LM_CONTROL)
    bptt = cfg["bptt"]
    tok = synthetic_lm("WikiText2", "train", 100 * bptt * args.steps).token
    lr = torch.full((), 0.1, dtype=torch.float32, device=dev)
    model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
    eng = RoundEngine(model, cfg, dev)
    if dev.type == "cuda" and eng.fused_mode != "cuda":
        raise AssertionError("the fused-SGD kernel is not selected")
    P = eng.flatten(model.params())
    row = torch.from_numpy(tok[: bptt * args.steps].reshape(1, -1)).to(dev)
    lm = torch.ones(cfg["num_tokens"], dtype=torch.float32, device=dev)

    def fed(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        _, acc = eng.local_train_lm(P, 1.0, row, lm, gen, lr)
        return acc

    ccfg = cfg_of(CENTRAL)
    cmodel = make_model(ccfg).init_(torch.Generator().manual_seed(0)).to(dev)
    ceng = CentralEngine(cmodel, ccfg, dev)
    params = {k: v.detach().clone() for k, v in cmodel.params().items()}
    xs, ws = stack_windows(bptt_windows(batchify(tok, 100), bptt), bptt)
    wins = (torch.from_numpy(xs).to(dev), torch.from_numpy(ws).to(dev))

    def central(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        _, _, acc = ceng.train_epoch(params, ceng.init_opt(params), 0.1, *wins, gen=gen)
        return acc

    for name, run, shape in (("federated", fed, "[1, 64]"), ("centralised", central, "[100, 64]")):
        r = measure(torch, dev, run, args.steps, args.repeats)
        out[name] = r
        print(f"{name} step {shape}: {r['ms_per_step']['median']:.3f} ms (runs "
              f"{[round(t, 3) for t in r['ms_per_step']['all']]}); profiled "
              f"{r['profile_wall_ms_per_step']:.3f} ms, device busy "
              f"{r['device_busy_ms_per_step']:.3f} ms ({100 * r['device_busy_share']:.1f}%), "
              f"{r['kernel_launches_per_step']:.1f} kernel launches", flush=True)
        for b, v in sorted(r["buckets"].items(), key=lambda kv: -kv[1]["device_ms_per_step"]):
            print(f"  {b}: {v['device_ms_per_step']:.4f} ms, {v['launches_per_step']:.1f} "
                  f"launches", flush=True)
        for t in r["top"][:12]:
            print(f"  {t['device_ms'] / args.steps:8.4f} ms  {t['calls'] / args.steps:6.1f}  "
                  f"{t['name'][:100]}", flush=True)
        if dev.type == "cuda" and not r["top"]:
            raise AssertionError("the profiler recorded no device time")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
