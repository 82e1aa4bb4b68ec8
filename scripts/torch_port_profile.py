#!/usr/bin/env python3
"""Where a local training step of the PyTorch/CUDA port spends its time.

One client of the headline run (control
``1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1``: full-width ResNet-18, CIFAR10
shapes, 500 samples, batch 10, so 50 steps per local epoch) trains through
``RoundEngine.local_train`` on synthetic data.  Two measurements:

1. step time of four routes -- the batch-norm kernels or the two-pass
   PyTorch batch norm (``pallas_norm`` 1/0) times the fused-SGD kernel or
   the unfused per-leaf optimizer chain (``fused_update`` 1/0) -- on the
   host clock around ``synchronize``, one local epoch per sample, the
   routes in turns (ABCD DCBA ...), median per route;
2. a ``torch.profiler`` trace of one local epoch of the all-kernel route:
   device time by kernel name, kernel launches per step, the device's busy
   share of the window's wall time (the grouped step's gradient pack, the
   ``torch.cat`` of ``GroupedRoundEngine._step``, from the second epoch's
   shapes); then a second epoch traced with Python
   stacks and shapes says where the copies come from (each ``aten::copy_``
   by its nearest autograd node, or ``forward``, the ops that called it,
   the shape it copied and the port's source line, where one is on the
   stack).

Run from the repository root on a machine with a CUDA device::

    python3 scripts/torch_port_profile.py --out torch_port_profile.json

``--model resnet50`` profiles the bottleneck ResNet-50 instead, and
``--width 0.0625`` a client of a narrower level (the width rate; a dynamic
round mixes the levels' steps).  ``--clients G`` profiles the grouped
engine instead: a step of G clients of the level ``--width`` batched
through its dense sub-model (``GroupedRoundEngine.local_train_level``, the
batched kernels, under cuDNN's deterministic algorithms as the grouped
round runs), timed in turns against the same G clients trained one after
another by the masked engine (both kernel routes); times are per batched
step, that is per G masked steps.

``--graph`` times the superstep's unit instead: the same client's local
epoch eagerly (``local_train``; with ``--clients G`` the grouped
``local_train_level``), with each step replayed from its captured CUDA
graph (``RoundEngine.client_step`` / ``GroupedRoundEngine.level_step``, the
superstep's path, parallel/step_graph.py), and with the client's whole
epoch captured as one graph; in turns, per step on the host clock; the
profile is then taken of the replayed steps (launches a step under
replay, the device's busy share), and the captures' seconds and pool bytes
are printed.

``--compute_dtype bfloat16`` runs each conv's and linear's operands in
bf16 (float32 accumulation) and ``--conv_impl im2col`` computes each
convolution as patch extraction plus a matmul (with ``--clients G`` one
batched matmul of each client's patches by its own weights instead of the
grouped convolution); the device time is then bucketed into convolutions,
cuDNN's layout transposes, matmuls, the port's BN and SGD kernels and the
rest.

``--device cpu --samples 20`` rehearses the control flow on the CPU (no
device numbers come out of that).
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
HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
ROUTES = [("bn kernel + sgd kernel", True, True), ("bn two-pass + sgd kernel", False, True),
          ("bn kernel + sgd chain", True, False), ("bn two-pass + sgd chain", False, False)]
# kernel-name fragments of each bucket of device time, checked in order
BUCKETS = [("port bn kernels", ("bn_fwd_", "bn_bwd_")),
           ("port sgd kernel", ("sgd_norm_partial", "sgd_apply", "sgd_batched")),
           ("cudnn layout transposes", ("nhwctonchw", "nchwtonhwc")),
           ("convolution", ("conv", "cudnn", "implicit", "winograd", "dgrad", "wgrad", "fprop")),
           ("matmul", ("gemm", "xmma", "sm90_", "cutlass", "gemv", "nvjet"))]


def bucket_of(name: str) -> str:
    low = name.lower()
    for label, frags in BUCKETS:
        if any(f in low for f in frags):
            return label
    return "other"


def pack_time(events, on_device: bool):
    """Device ms and calls of the grouped step's gradient pack (the
    ``torch.cat(..., out=g)`` of ``GroupedRoundEngine._step``,
    parallel/grouped.py: the step's one ``aten::cat`` given an output) in a
    profile taken with ``record_shapes`` -> ``{"device_ms": t, "calls": n}``."""
    out = {"device_ms": 0.0, "calls": 0}
    for evt in events:
        shapes = getattr(evt, "input_shapes", None) or []
        if evt.name != "aten::cat" or len(shapes) != 3 or not shapes[2]:
            continue
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if on_device and dev_us <= 0:
            continue
        out["device_ms"] += dev_us / 1e3
        out["calls"] += 1
    return out


def copy_sources(events, on_device: bool):
    """``{source: {"copies": n, "device_ms": t}}`` for every ``aten::copy_``
    in a profile (on the device: those that ran device work), keyed by the
    nearest enclosing autograd node (``forward`` when there is none), the
    ops that called the copy (innermost first), the shape copied and the
    innermost frame of the port's package on the Python stack (a trace
    taken ``with_stack`` and ``record_shapes``)."""
    out = {}
    for evt in events:
        if evt.name != "aten::copy_":
            continue
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        if on_device and dev_us <= 0:
            continue
        parents, p = [], evt.cpu_parent
        while p is not None:
            parents.append(p)
            p = p.cpu_parent
        chain = [e.name for e in parents]
        node = next((n.split(": ", 1)[1] for n in chain
                     if n.startswith("autograd::engine::evaluate_function: ")), "forward")
        ops = [n for n in chain if n.startswith("aten::")]
        shape = next((list(x) for x in getattr(evt, "input_shapes", None) or [] if x), [])
        key = f"{node} <- {' < '.join(ops[:3]) or 'top level'} {shape}"
        # the port's innermost frame: on the op or an enclosing one's stack,
        # or an enclosing Python-function event
        frames = [f for e in [evt] + parents for f in (getattr(e, "stack", None) or [])]
        frame = next((f for f in frames + chain if "heterofl_tpu_torch" in f), None)
        if frame:
            key += " at " + frame[frame.index("heterofl_tpu_torch"):]
        r = out.setdefault(key, {"copies": 0, "device_ms": 0.0})
        r["copies"] += 1
        r["device_ms"] += dev_us / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samples", type=int, default=500, help="the client's samples (500: headline)")
    ap.add_argument("--repeats", type=int, default=10, help="timed epochs per route")
    ap.add_argument("--model", default="resnet18", help="resnet18 (headline) or resnet50")
    ap.add_argument("--width", type=float, default=1.0, help="the client's width rate")
    ap.add_argument("--clients", type=int, default=0,
                    help="G > 0: the grouped engine's step of G clients at --width")
    ap.add_argument("--graph", action="store_true",
                    help="eager against replayed steps against one graph a client")
    ap.add_argument("--compute_dtype", default="float32", help="float32 or bfloat16")
    ap.add_argument("--conv_impl", default="direct", help="direct or im2col")
    ap.add_argument("--out", default=None, help="write the results here as JSON")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch import resolve_device
    from heterofl_tpu_torch.data import synthetic_vision
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine

    dev = resolve_device({"device": args.device})
    out = {"device": str(dev), "model": args.model, "width": args.width,
           "compute_dtype": args.compute_dtype, "conv_impl": args.conv_impl}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(out["nvidia_smi"], flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ds = synthetic_vision("CIFAR10", "train", n=args.samples, seed=0)
    x = torch.from_numpy(ds.data).to(dev)
    y = torch.from_numpy(ds.target).to(dev)
    sm = torch.ones(args.samples, dtype=torch.float32, device=dev)
    lm = torch.ones(10, dtype=torch.float32, device=dev)
    lr = torch.full((), 0.1, dtype=torch.float32, device=dev)
    engines = {}
    init = None
    for label, bn_kernel, sgd_kernel in ROUTES:
        cfg = C.default_cfg()
        cfg["control"] = C.parse_control_name(HEADLINE)
        cfg["model_name"] = args.model
        cfg["pallas_norm"] = bn_kernel
        cfg["fused_update"] = sgd_kernel
        cfg["override"] = {"num_epochs": {"global": 1, "local": 1}}
        cfg["compute_dtype"], cfg["conv_impl"] = args.compute_dtype, args.conv_impl
        cfg = C.process_control(cfg)
        cfg["classes_size"] = 10
        model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
        if init is None:
            init = {k: v.detach().clone() for k, v in model.params().items()}
        engines[label] = RoundEngine(model, cfg, dev)
        if sgd_kernel and dev.type == "cuda" and engines[label].fused_mode != "cuda":
            raise AssertionError(f"{label}: the fused-SGD kernel is not selected")
    steps = -(-args.samples // engines[ROUTES[0][0]].batch_size)
    P = engines[ROUTES[0][0]].flatten(init)

    def epoch(label, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        p, acc = engines[label].local_train(P, args.width, x, y, sm, lm, gen, lr)
        return acc

    order = [r[0] for r in ROUTES]
    if args.clients:
        G = args.clients
        kernels = ROUTES[0][0]
        grouped = GroupedRoundEngine(engines[kernels].model, engines[kernels].cfg, dev)
        level = grouped.levels[args.width * grouped.cfg["global_model_rate"]]
        data = (x.expand(G, *x.shape), y.expand(G, -1), sm.expand(G, -1), lm.expand(G, -1))
        uids = torch.arange(G, device=dev)
        masked = f"masked, {G} clients one after another"

        def epoch(label, seed):  # noqa: F811 -- the grouped step and its masked twin
            # each engine's cuDNN setting: the grouped round's deterministic algorithms
            torch.backends.cudnn.deterministic = label != masked
            if label == masked:
                return torch.stack([engines[kernels].local_train(
                    P, args.width, x, y, sm, lm, torch.Generator(device=dev).manual_seed(
                        seed + i), lr)[1] for i in range(G)])
            gens = [torch.Generator(device=dev).manual_seed(seed + i) for i in range(G)]
            return grouped.local_train_level(level, P, uids, data, gens, lr)[1]

        order = [f"grouped, {G} clients batched", masked]
        out["clients"] = G
    if args.graph:
        from heterofl_tpu_torch.parallel import step_graph

        eng = engines[ROUTES[0][0]]
        wr = args.width
        eager_epoch = epoch
        if args.clients:
            users = list(range(args.clients))
            lv = level

            def unit(seed):  # the grouped superstep's level step and its buffers
                step, st, gens = grouped.level_step(lv, args.clients, P, data)
                grouped.stage_level(lv, st, gens, P, uids, users, data, seed)
                grouped._lr.fill_(0.1)
                body = grouped._counted_level_step_lm if grouped.is_lm \
                    else grouped._counted_level_step
                return step, st, (lambda: body(lv, st, gens)), gens, grouped.graphs
        else:
            one = (x[None], y[None], sm[None], lm[None])

            def unit(seed):  # the masked superstep's client step and its buffers
                step, st = eng.client_step(wr, P, one)
                eng.stage_client(st, P, wr, 0, one, seed)
                st["lr"].fill_(0.1)
                return step, st, (lambda: eng._counted_vision_step(
                    st, wr, eng.param_mask_flat(wr), eng._ggen)), [eng._ggen], eng.graphs

        def epoch(label, seed):  # noqa: F811 -- eager, replayed steps, one graph a client
            torch.backends.cudnn.deterministic = bool(args.clients)
            if label == "eager":
                return eager_epoch(order0[0], seed)
            step, st, body, gens, graphs = unit(seed)
            if label == "replayed steps":
                for _ in range(st["steps"]):
                    step.replay()
            else:
                whole = graphs.get(("whole client", args.clients, wr),
                                   lambda: [body() for _ in range(st["steps"])],
                                   st["t"].zero_, gens)
                unit(seed)  # the capture's warm-up wrote into the buffers
                whole.replay()
            return st["acc"]

        order0 = order
        order = ["replayed steps", "eager", "one graph a client"]
        out["graph"] = True
    for label in order:  # warm-up: kernel build, cuDNN plans, allocator
        epoch(label, 0)
    sync()
    times = {label: [] for label in order}
    for rep in range(args.repeats):
        for label in (order if rep % 2 == 0 else order[::-1]):
            sync()
            t0 = time.perf_counter()
            acc = epoch(label, rep + 1)
            sync()
            times[label].append((time.perf_counter() - t0) * 1e3 / steps)
            if not bool(torch.isfinite(acc).all()):
                raise AssertionError(f"{label}: non-finite loss")
    out["steps_per_epoch"] = steps
    out["ms_per_step"] = {k: {"median": statistics.median(v), "all": v} for k, v in times.items()}
    if args.graph:
        out["graph_stats"] = dict(step_graph.STATS)
        print(f"graphs: {step_graph.STATS['captures']} captures in "
              f"{step_graph.STATS['capture_seconds']:.2f} s (warm-up included), pools "
              f"{step_graph.STATS['pool_bytes'] / 1e6:.1f} MB", flush=True)
    for k, v in times.items():
        print(f"{k}: {statistics.median(v):.3f} ms/step (runs {[round(t, 3) for t in v]})",
              flush=True)

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    label = order[0]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        epoch(label, 99)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    sync()
    with profile(activities=acts, with_stack=True, record_shapes=True) as prof_stack:
        epoch(label, 98)
        sync()
    copies = copy_sources(prof_stack.events(), dev.type == "cuda")
    # a replayed step calls no op on the host: the pack is within the graph
    pack = pack_time(prof_stack.events(), dev.type == "cuda") \
        if args.clients and not args.graph else None
    out["profile"] = {"route": label, "steps": steps, "wall_ms": wall_ms,
                      "device_busy_ms": busy,
                      "device_busy_share": busy / wall_ms if wall_ms else 0.0,
                      "kernel_launches_per_step": sum(r["calls"] for r in rows) / steps,
                      "buckets": buckets, "top": rows[:25], "copy_sources": copies,
                      "gradient_pack": pack}
    print(f"profile ({label}, {steps} steps): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * out['profile']['device_busy_share']:.1f}%), "
          f"{out['profile']['kernel_launches_per_step']:.1f} kernel launches per step", flush=True)
    for b, v in sorted(buckets.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"  {b}: {v['device_ms'] / steps:.3f} ms/step device, "
              f"{v['launches'] / steps:.1f} launches/step", flush=True)
    if pack is not None:  # from the second epoch, traced with shapes
        print(f"  gradient pack (torch.cat in GroupedRoundEngine._step, within 'other'): "
              f"{pack['device_ms'] / steps:.3f} ms/step device, {pack['calls'] / steps:.1f} "
              f"calls/step", flush=True)
    for r in rows[:25]:
        print(f"  {r['device_ms'] / steps:8.4f} ms/step  {r['calls'] / steps:6.1f}/step  "
              f"{r['name'][:110]}", flush=True)
    print("copies by source (aten::copy_; a second epoch, traced with stacks):", flush=True)
    for k, v in sorted(copies.items(), key=lambda kv: -kv[1]["copies"]):
        print(f"  {v['copies'] / steps:6.1f}/step  {v['device_ms'] / steps:8.4f} ms/step  {k}",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if dev.type == "cuda" and not rows:
        raise AssertionError("the profiler recorded no device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
