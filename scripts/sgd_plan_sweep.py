#!/usr/bin/env python3
"""Device time of the batched fused-SGD kernel (3b) under each launch plan,
at the grouped engine's shapes.

At each shape -- full-width ResNet-18's client at level a with G = 1, 2
and 4, levels b, c and d with G = 2, level e with G = 2 and 4, and the
transformer's at levels a to d with G = 2 -- the kernel of
``csrc/fused_sgd.cu`` runs on the plan ``ops/fused_update.py::
sgd_plan_batched`` picks (marked ``*``) and on its variants: the other
route where a row has at most 16 parts (persistent grid or a cluster a
row), rows a pass 1, 2, 4 and 8 (persistent), and the rows unpadded
(``ld = n``: four scalar loads a chunk where n is not a multiple of 4) or
read as scalars.  Every variant must give the plan's bits, row by row the
one-client kernel's; each is timed by device time (10 calls captured in
one CUDA graph and replayed, ``chip_smoke.graph_ms``) beside its launch
floor (the empty kernel ``hfl_sgd_floor`` on the same grid, cluster and
attributes, alone and with the route's barrier) and the grid it launches.
Run from the repository root on a machine with a CUDA device::

    python3 scripts/sgd_plan_sweep.py --out sgd_plan_sweep.json

``--roots OLD . . OLD`` instead runs, for each checkout in a process of its
own and in the order given, the 3b phase of its ``chip_smoke.py``
(``sgd_batched_phase``: the kernel held and timed) and then ``TIMED``
shapes (the phase's three, then G = 2 at ResNet-18's levels b-d and the
LM's levels b-d) through its own wrapper, in the row layout its grouped engine
uses (padded where it has ``row_stride``), and prints each one's device
times: the comparison of two versions on one card, in turns.  Unpack the
parent first, e.g. ``git archive <rev> | tar -x -C chip_archive/parent``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (model, level rate, G) of the sweep; the timed ones in turns: chip_smoke's
# three, then ResNet-18's and the LM's levels b-d at G = 2
SHAPES = [("resnet18", 1.0, 2), ("resnet18", 0.0625, 4), ("transformer", 1.0, 2),
          ("resnet18", 1.0, 4), ("resnet18", 1.0, 1), ("resnet18", 0.5, 2),
          ("resnet18", 0.25, 2), ("resnet18", 0.125, 2), ("resnet18", 0.0625, 2),
          ("transformer", 0.5, 2), ("transformer", 0.25, 2), ("transformer", 0.125, 2)]
TIMED = SHAPES[:3] + SHAPES[5:8] + SHAPES[9:]
ROWS = (1, 2, 4, 8)
KW = dict(momentum=0.9, weight_decay=5e-4, max_norm=1.0)


def level_sizes(cs):
    """Parameters of a client at each level rate: ResNet-18 (headline cfg)
    and the transformer (``chip_smoke.lm_cfg``), from ``make_model``."""
    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.ops.fused_update import FlatSpec

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(cs.HEADLINE)
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    size = {}
    for name, c in (("resnet18", cfg), ("transformer", cs.lm_cfg())):
        for rate in cs.LEVELS:
            size[name, rate] = FlatSpec.of(dict(make_model(c, rate).named_parameters())).total
    return size


def inputs(torch, gen, n: int, G: int, ld: int):
    """``g, p, buf [G, n]`` views of ``[G, ld]`` rows, a mask with 10%
    zeros, ``scal`` with every row's ``has`` 1 and row 0 clipping."""
    dev = torch.device("cuda")
    g, p, buf = (torch.zeros(G, ld, device=dev)[:, :n] for _ in range(3))
    g.normal_(generator=gen)
    g[1:] *= 1e-5
    p.normal_(generator=gen)
    buf.normal_(generator=gen).mul_(0.1)
    mask = (torch.rand(n, device=dev, generator=gen) < 0.9).to(torch.float32)
    scal = torch.tensor([[7.0, 0.1, 1.0]] * G, device=dev)
    return g, p, buf, mask, scal


def variants(fu, n: int, G: int):
    """(label, ld, plan) of every variant at (n, G); the plan in use first."""
    from heterofl_tpu_torch.parallel.grouped import row_stride

    ld = row_stride(n)
    chosen = fu.sgd_plan_batched(n, G, ld)
    out = [("*", ld, chosen)]
    for route in ("persistent", "cluster"):
        if route == "cluster" and chosen.parts > fu.SGD_CLUSTER_PARTS:
            continue
        for rows in ([r for r in ROWS if r <= G] if route == "persistent" else [None]):
            pl = fu.sgd_plan_batched(n, G, ld, route=route, rows=rows)
            if pl != chosen:
                out.append((f"{route} rows {pl.rows}", ld, pl))
    out.append(("unpadded", n, fu.sgd_plan_batched(n, G, n)))
    out.append(("scalar loads", ld, chosen._replace(vec=1)))
    return out


def one_client(fu, g0, p0, b0, mask, scal):
    """The one-client kernel on each row -> [(p, buf)]."""
    want = []
    for i in range(g0.shape[0]):
        pu, bu = p0[i].clone(), b0[i].clone()
        fu.fused_sgd_cuda(g0[i].clone(), pu, bu, mask, scal[i].clone(), **KW)
        want.append((pu, bu))
    return want


def same_rows(torch, cs, p, buf, want) -> bool:
    torch.cuda.synchronize()
    return all(cs.same_bits(torch, p[i], pu) and cs.same_bits(torch, buf[i], bu)
               for i, (pu, bu) in enumerate(want))


def sweep(torch, cs, fu, size, gen):
    """Every variant of :func:`variants` at SHAPES, held to the plan's bits
    and to the one-client kernel on each row, timed with its floors -> the
    table's rows."""
    table = []
    for model, rate, G in SHAPES:
        n = size[model, rate]
        print(f"{model} level {rate:g} n={n} G={G}", flush=True)
        g0, p0, b0, mask, scal = inputs(torch, gen, n, G, n)
        want = one_client(fu, g0, p0, b0, mask, scal)
        for label, ld, pl in variants(fu, n, G):
            g, p, buf = (torch.zeros(G, ld, device="cuda")[:, :n] for _ in range(3))
            g.copy_(g0)
            p.copy_(p0)
            buf.copy_(b0)
            fu.fused_sgd_batched_cuda(g, p, buf, mask, scal, plan=pl, **KW)
            if not same_rows(torch, cs, p, buf, want):
                raise AssertionError(f"{model} n={n} G={G} {label}: a row differs from the "
                                     f"one-client kernel")

            def run(pl=pl, g=g, p=p, buf=buf):
                fu.fused_sgd_batched_cuda(g, p, buf, mask, scal, plan=pl, **KW)
            floor, grid = cs.sgd_floor_call(torch, fu, pl, n, G)
            row = {"model": model, "rate": rate, "G": G, "n": n, "ld": ld, "variant": label,
                   "route": pl.route, "rows": pl.rows, "vec": pl.vec, "parts": pl.parts,
                   "grid": grid, "device_us": cs.graph_ms(run, calls=10, samples=11) * 1e3,
                   "floor_us": cs.graph_ms(floor, calls=10, samples=11) * 1e3,
                   "floor_sync_us": cs.graph_ms(cs.sgd_floor_call(torch, fu, pl, n, G, True)[0],
                                                calls=10, samples=11) * 1e3}
            nbytes = 4 * ((5 * G + 1) * n + 3 * G)
            row["bound_us"] = nbytes / cs.BW * 1e6
            table.append(row)
            print(f"  {label:>22}: {pl.route} rows {pl.rows} vec {pl.vec} grid {row['grid']}: "
                  f"device {row['device_us']:.2f} us (bound {row['bound_us']:.2f}, "
                  f"{100 * row['bound_us'] / row['device_us']:.0f}%), floor "
                  f"{row['floor_us']:.2f}, with its barrier {row['floor_sync_us']:.2f}",
                  flush=True)
            del g, p, buf
        del g0, p0, b0, want
        torch.cuda.empty_cache()
    return table


def one_phase(root: str) -> int:
    """The 3b phase of the checkout at ``root`` and its TIMED shapes through
    its own wrapper and row layout, in this process; the times as the last
    line (JSON)."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from heterofl_tpu_torch.ops import fused_update as fu
    from heterofl_tpu_torch.parallel import grouped

    size = level_sizes(cs)
    n_by_rate = {rate: size["resnet18", rate] for rate in cs.LEVELS}
    lm = {rate: size["transformer", rate] for rate in (1.0, 0.0625)}
    args = (torch, fu, n_by_rate) + ((lm,) if len(inspect.signature(
        cs.sgd_batched_phase).parameters) > 3 else ())
    phase = cs.sgd_batched_phase(*args)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(3)
    timed = []
    for model, rate, G in TIMED:
        n = size[model, rate]
        ld = grouped.row_stride(n) if hasattr(grouped, "row_stride") else n
        g, p, buf, mask, scal = inputs(torch, gen, n, G, ld)
        if ld == n:
            g, p, buf = g.contiguous(), p.contiguous(), buf.contiguous()

        def run():
            fu.fused_sgd_batched_cuda(g, p, buf, mask, scal, **KW)
        timed.append({"model": model, "rate": rate, "G": G, "n": n, "ld": ld,
                      "device_ms": cs.graph_ms(run, calls=10, samples=11),
                      "ms": cs.time_ms(run, reps=5, samples=15)})
        del g, p, buf
        torch.cuda.empty_cache()
    print(json.dumps({"phase": phase["by_level"], "timed": timed}, default=str), flush=True)
    return 0


def in_turns(roots, out) -> int:
    """:func:`one_phase` of each root in a process of its own, in order."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for root in roots:
        got = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                             capture_output=True, text=True)
        if got.returncode != 0:
            print(got.stdout[-4000:], got.stderr[-4000:], file=sys.stderr)
            return got.returncode
        res = json.loads(got.stdout.strip().splitlines()[-1])
        for r in res["timed"]:
            print(f"{root}: {r['model']} level {r['rate']:g} G={r['G']} n={r['n']} ld={r['ld']}: "
                  f"device {r['device_ms']:.4f} ms, call {r['ms']:.4f} ms", flush=True)
        for r in res["phase"]:
            print(f"{root}:   its phase: G={r['G']} level {r['rate']:g} n={r['n']}: device "
                  f"{r['device_ms']:.4f} ms, call {r['ms']:.4f} ms", flush=True)
        runs.append({"root": root, **res})
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the table here as JSON")
    ap.add_argument("--roots", nargs="+", default=None,
                    help="time the 3b phase of these checkouts in turns")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one_phase(args.one)
    if args.roots:
        return in_turns(args.roots, args.out)

    import torch

    if not torch.cuda.is_available():
        print("sgd_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from heterofl_tpu_torch.ops import _build, fused_update as fu

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.load()
    table = sweep(torch, cs, fu, level_sizes(cs),
                  torch.Generator(device=torch.device("cuda")).manual_seed(0))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "table": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
