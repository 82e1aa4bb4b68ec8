#!/usr/bin/env python3
"""Device time of the batch-norm kernels under every launch plan, at the
shapes of ResNet-18's batch-norm sites at batch 10.

For each site shape ``[M, C]`` and each channel tile (4-128 channels) and
cluster size (1-16 blocks) with at most 64 row iterations a thread, the
plan is built by ``ops/fused_norm.py::plan_for``, both kernels of
``csrc/bn.cu`` are launched on it and held against their plain versions
(``chip_smoke.TOL_BN``), and each is timed by device time: 20 calls
captured in one CUDA graph and replayed (``chip_smoke.graph_ms``).  The
plan ``bn_plan`` picks is marked ``*``.  This is what ``bn_plan``'s choice
rests on.  Run from the repository root on a machine with a CUDA device::

    python3 scripts/bn_plan_sweep.py --out bn_plan_sweep.json

``--batched`` sweeps the batched kernels (the grouped engine's) instead, at
the 60 (level, G, site) shapes ``chip_smoke.py`` holds (``BN_SHAPES`` x
``LEVELS`` x ``GROUPED_G``: ``x2 [M, G * C]`` with C the site's width at
the level), with random ``[G, B]`` weights in which each client has a
zero-weight sample.  Beside each plan it times the plan's launch floor: the
empty kernel ``hfl_bn_floor`` on the same grid, cluster and shared memory
(``chip_smoke.floor_call``).  The full table goes to ``--out``; standard
output has a line a shape (the plan in use, the best plan in each
direction) and the totals of a 17-site step a (level, G)::

    python3 scripts/bn_plan_sweep.py --batched --out bn_sweep_batched.json

``--roots OLD . . OLD`` instead runs the batched batch-norm phase of
``chip_smoke.py`` (``bn_batched_phase``: the kernels held at the 60 shapes,
then a step of 17 sites timed at G = 2, levels a and e) of each checkout in
a process of its own, in the order given, and prints each one's times: the
comparison of two versions on one card, in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


TILES = (4, 8, 16, 32, 64, 128)
CLUSTERS = (1, 2, 4, 8, 16)
MAX_ITERS = 64
MAX_BLOCKS = 264  # two blocks an SM of an H100


def batched_plans(fn, M: int, C: int, Cg: int, P: int, chosen):
    """The plans a batched shape is swept over: every (tile_c, cluster) with
    rows for every block, at most MAX_ITERS row iterations a thread and
    MAX_BLOCKS blocks, and the plan in use first."""
    out = [chosen]
    for tile_c in TILES:
        if tile_c > max(4, 1 << (C - 1).bit_length()):
            continue
        for cluster in CLUSTERS:
            pl = fn.plan_for_batched(M, C, Cg, P, tile_c, cluster)
            if (pl.iters <= MAX_ITERS and pl.tiles * cluster <= MAX_BLOCKS
                    and (cluster - 1) * pl.rows < M and pl not in out):
                out.append(pl)
    return out


def sweep_batched(torch, cs, fn, dev, gen):
    """Every plan of :func:`batched_plans` at the 60 (level, G, site) shapes,
    held against the plain versions (``chip_smoke.TOL_BN``) and timed by
    device time with its launch floor, the kernels launched as the wrappers
    launch them (``fused_norm.BN_BATCHED_PDL``: dependent launches or not);
    the plan in use also eagerly (the call's time on the host clock, and the
    device's time a call launched behind a queue, ``chip_smoke.queued_ms``),
    each both ways in turns -> the table's rows."""
    pdl = fn.BN_BATCHED_PDL
    table, steps = [], []
    for rate in cs.LEVELS:
        for G in cs.GROUPED_G:
            step = dict.fromkeys(("chosen_fwd_us", "chosen_bwd_us", "best_fwd_us", "best_bwd_us",
                                  "floor_us", "turns_fwd_us", "turns_bwd_us", "other_fwd_us",
                                  "other_bwd_us", "queued_fwd_us", "queued_bwd_us",
                                  "queued_other_fwd_us", "queued_other_bwd_us"), 0.0)
            step.update(rate=rate, G=G)
            for M, C0, sites in cs.BN_SHAPES:
                Cg = cs.level_width(C0, rate)
                C, P, B = G * Cg, M // cs.BATCH, cs.BATCH
                x, dy = (torch.randn(M, C, device=dev, generator=gen) for _ in range(2))
                g, b = (torch.randn(C, device=dev, generator=gen) for _ in range(2))
                w = torch.rand(G, B, device=dev, generator=gen) + 0.5
                q = torch.arange(G, device=dev)
                w[q, (3 * q + 1) % B] = 0.0  # a zero-weight sample in each client
                y_p, st = fn.bn_fwd_batched_plain(x, w, P, g, b)
                dx_p, dg_p, db_p = fn.bn_bwd_batched_plain(x, w, P, g, dy, st)
                chosen = fn.bn_plan_batched(M, C, Cg, P)
                rows = []
                for pl in batched_plans(fn, M, C, Cg, P, chosen):
                    def run_fwd(pl=pl):
                        return fn.bn_fwd_batched_cuda(x, w, P, g, b, plan=pl)

                    def run_bwd(pl=pl):
                        return fn.bn_bwd_batched_cuda(x, w, P, g, dy, st, plan=pl)

                    y, stats = run_fwd()
                    dx, dg, db = run_bwd()
                    torch.cuda.synchronize()
                    for out, ref, tol in ((y, y_p, "y"), (stats, st, "y"), (dx, dx_p, "dx"),
                                          (dg, dg_p, "dg"), (db, db_p, "db")):
                        atol, rtol = cs.TOL_BN[tol]
                        torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
                    row = {"rate": rate, "G": G, "M": M, "C": C, "Cg": Cg, "sites": sites,
                           "tile_c": pl.tile_c, "cluster": pl.cluster, "iters": pl.iters,
                           "blocks": pl.tiles * pl.cluster, "resident_bwd": pl.resident_bwd,
                           "chosen": pl == chosen,
                           "fwd_us": cs.graph_ms(run_fwd) * 1e3,
                           "bwd_us": cs.graph_ms(run_bwd) * 1e3,
                           "floor_fwd_us": cs.graph_ms(cs.floor_call(
                               torch, pl.tiles, pl.cluster, pl.smem_fwd, pdl)) * 1e3,
                           "floor_bwd_us": cs.graph_ms(cs.floor_call(
                               torch, pl.tiles, pl.cluster, pl.smem_bwd, pdl)) * 1e3}
                    if pl == chosen:  # eagerly too; and as plain launches, in turns
                        for on in (pdl, not pdl, not pdl, pdl):
                            fn.BN_BATCHED_PDL = on
                            sfx = "" if on == pdl else "_other"
                            for k, f in (("fwd", run_fwd), ("bwd", run_bwd)):
                                row.setdefault(f"{k}_us_turns{sfx}", []).append(
                                    cs.graph_ms(f) * 1e3)
                                row.setdefault(f"{k}_queued_us{sfx}", []).append(
                                    cs.queued_ms(f) * 1e3)
                                row.setdefault(f"{k}_call_us{sfx}", []).append(
                                    cs.time_ms(f) * 1e3)
                        fn.BN_BATCHED_PDL = pdl
                    rows.append(row)
                ch = rows[0]
                bf = min(rows, key=lambda r: r["fwd_us"])
                bb = min(rows, key=lambda r: r["bwd_us"])
                print(f"level {rate:g} G {G} M={M} C={C} (Cg {Cg}, {sites} sites): in use "
                      f"({ch['tile_c']}, {ch['cluster']}) fwd {ch['fwd_us']:.2f} bwd "
                      f"{ch['bwd_us']:.2f} floor {ch['floor_fwd_us']:.2f} us; best fwd "
                      f"({bf['tile_c']}, {bf['cluster']}) {bf['fwd_us']:.2f} [floor "
                      f"{bf['floor_fwd_us']:.2f}], best bwd ({bb['tile_c']}, {bb['cluster']}) "
                      f"{bb['bwd_us']:.2f} [floor {bb['floor_bwd_us']:.2f}]; {len(rows)} plans",
                      flush=True)
                step["chosen_fwd_us"] += sites * ch["fwd_us"]
                step["chosen_bwd_us"] += sites * ch["bwd_us"]
                step["best_fwd_us"] += sites * bf["fwd_us"]
                step["best_bwd_us"] += sites * bb["bwd_us"]
                step["floor_us"] += sites * ch["floor_fwd_us"]
                for k in ("fwd", "bwd"):
                    step[f"turns_{k}_us"] += sites * statistics.mean(ch[f"{k}_us_turns"])
                    step[f"other_{k}_us"] += sites * statistics.mean(ch[f"{k}_us_turns_other"])
                    step[f"queued_{k}_us"] += sites * statistics.mean(ch[f"{k}_queued_us"])
                    step[f"queued_other_{k}_us"] += sites * statistics.mean(
                        ch[f"{k}_queued_us_other"])
                table += rows
            steps.append(step)
    for st in steps:
        print(f"step of 17 sites, level {st['rate']:g} G {st['G']}: in use fwd "
              f"{st['chosen_fwd_us']:.1f} bwd {st['chosen_bwd_us']:.1f} us; best plans fwd "
              f"{st['best_fwd_us']:.1f} bwd {st['best_bwd_us']:.1f} us; floor of the plan in "
              f"use {st['floor_us']:.1f} us; in turns, dependent launches {'on' if pdl else 'off'} "
              f"fwd {st['turns_fwd_us']:.1f} bwd {st['turns_bwd_us']:.1f} us, "
              f"{'off' if pdl else 'on'} fwd {st['other_fwd_us']:.1f} bwd "
              f"{st['other_bwd_us']:.1f} us; launched eagerly behind a queue, "
              f"{'on' if pdl else 'off'} fwd {st['queued_fwd_us']:.1f} bwd "
              f"{st['queued_bwd_us']:.1f} us, {'off' if pdl else 'on'} fwd "
              f"{st['queued_other_fwd_us']:.1f} bwd {st['queued_other_bwd_us']:.1f} us",
              flush=True)
    return table


def one_phase(root: str) -> int:
    """The batched phase of the checkout at ``root``, in this process; its
    steps' times as the last line (JSON)."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    from heterofl_tpu_torch.ops import fused_norm as fn

    tot = cs.bn_batched_phase(torch, fn)
    print(json.dumps({k: v["by_level"] for k, v in tot.items()}), flush=True)
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
        steps = json.loads(got.stdout.strip().splitlines()[-1])
        for k, levels in steps.items():
            for r in levels:
                print(f"{root}: {k} G={r['G']} level {r['rate']:g}: device {r['device_ms']:.4f} "
                      f"ms, call {r['ms']:.4f} ms", flush=True)
        runs.append({"root": root, "steps": steps})
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"nvidia_smi": smi, "runs": runs}, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the table here as JSON")
    ap.add_argument("--batched", action="store_true",
                    help="sweep the batched kernels at the grouped engine's shapes")
    ap.add_argument("--roots", nargs="+", default=None,
                    help="time the batched phase of these checkouts in turns")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one_phase(args.one)
    if args.roots:
        return in_turns(args.roots, args.out)

    import torch

    if not torch.cuda.is_available():
        print("bn_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from heterofl_tpu_torch.ops import _build, fused_norm as fn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = _build.load()
    if args.batched:
        table = sweep_batched(torch, cs, fn, dev, gen)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"nvidia_smi": smi, "table": table}, f, indent=1)
        return 0
    fwd, bwd = lib.hfl_bn_fwd, lib.hfl_bn_bwd
    table = []
    for M, C, sites in cs.BN_SHAPES:
        P = M // cs.BATCH
        x, dy = (torch.randn(M, C, device=dev, generator=gen) for _ in range(2))
        g, b = (torch.randn(C, device=dev, generator=gen) for _ in range(2))
        w = torch.ones(cs.BATCH, device=dev)
        y_p, st = fn.bn_fwd_plain(x, w, P, g, b)
        dx_p = fn.bn_bwd_plain(x, w, P, g, dy, st)[0]
        y, stats, dx = torch.empty_like(x), torch.empty_like(st), torch.empty_like(x)
        dg, db = torch.empty(2, C, device=dev).unbind(0)
        chosen = fn.bn_plan(M, C)
        print(f"M={M} C={C} ({sites} sites per step)", flush=True)
        for tile_c in (4, 8, 16, 32, 64, 128):
            if tile_c > max(4, 1 << (C - 1).bit_length()):
                continue
            for cluster in (1, 2, 4, 8, 16):
                pl = fn.plan_for(M, C, tile_c, cluster)
                if pl.iters > 64:
                    continue
                # the current stream at each call: the graph captures on its own
                def run_fwd():
                    _build.check(fwd(x.data_ptr(), w.data_ptr(), P, g.data_ptr(), b.data_ptr(),
                                     y.data_ptr(), stats.data_ptr(), M, C, 1e-5, pl.tile_c,
                                     pl.cluster, pl.rows, pl.iters, pl.resident_fwd,
                                     _build.stream_of(x)), "bn_fwd")

                def run_bwd():
                    _build.check(bwd(x.data_ptr(), w.data_ptr(), P, g.data_ptr(), dy.data_ptr(),
                                     st.data_ptr(), dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                                     M, C, pl.tile_c, pl.cluster, pl.rows, pl.iters,
                                     pl.resident_bwd, _build.stream_of(x)), "bn_bwd")

                run_fwd()
                run_bwd()
                torch.cuda.synchronize()
                for out, ref, (atol, rtol) in ((y, y_p, cs.TOL_BN["y"]), (dx, dx_p, cs.TOL_BN["dx"])):
                    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
                row = {"M": M, "C": C, "tile_c": tile_c, "cluster": cluster, "iters": pl.iters,
                       "blocks": pl.tiles * pl.cluster, "chosen": pl == chosen,
                       "fwd_us": cs.graph_ms(run_fwd) * 1e3, "bwd_us": cs.graph_ms(run_bwd) * 1e3}
                table.append(row)
                print(f"  {'*' if row['chosen'] else ' '} tile_c {tile_c:3d} cluster {cluster:2d} "
                      f"iters {pl.iters:2d} blocks {row['blocks']:4d}: fwd {row['fwd_us']:.2f} us "
                      f"bwd {row['bwd_us']:.2f} us", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "table": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
