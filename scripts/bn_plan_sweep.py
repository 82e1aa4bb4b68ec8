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
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the table here as JSON")
    args = ap.parse_args(argv)

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
