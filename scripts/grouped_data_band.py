#!/usr/bin/env python3
"""How chaotic the grouped ResNet-18 round on the data axis is, on the CPU.

The grouped round of ResNet-18 (widths 8/16/16/16, control
``1_3_1_iid_fix_a2-e1_bn_1_1``, synthetic CIFAR10 with augmentation) on the
JAX package's ``GroupedRoundEngine``, on ``make_mesh(1, 2)`` and
``make_mesh(1, 1)``, from its key-0 init and from that init times ``1 +
1e-6 N(0, 1)``: the largest params difference between the two, the
reference's own band.  Then the port's round at ``(1, 2)`` on two gloo
ranks with the reference's epoch permutations and each data rank's
augmentation draws handed in, against the reference's on ``make_mesh(1,
2)``.  For each of ``--images`` (40: two local steps a client, 120:
four).  Prints one ``band`` line a case and, with ``--out``, writes them as
JSON.  Run from the repository root (the JAX package and the port both
import; no device needed)::

    JAX_PLATFORMS=cpu python3 scripts/grouped_data_band.py --images 40 120
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", type=int, nargs="+", default=[40, 120])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import jax
    import numpy as np

    from heterofl_tpu import config as RC
    from heterofl_tpu_torch import config as PC
    from test_torch_port_grouped import _cfg, _vision_data
    from test_torch_port_grouped_data import (LR, RESNET, _data_aug_draws, _flat, _init,
                                              _reference_round)
    from test_torch_port_round import reference_draws
    from torch_port_ranks import run_ranks

    rows = []
    for n_img in args.images:
        rcfg = _cfg(RC, RESNET, "resnet18", "CIFAR10", local=1)
        pcfg = _cfg(PC, RESNET, "resnet18", "CIFAR10", local=1)
        arrays = _vision_data("CIFAR10", 3, n_img)
        users = np.arange(3)
        p0 = _init(rcfg)
        rng = np.random.default_rng(1)
        p1 = {k: (v * (1 + 1e-6 * rng.standard_normal(v.shape))).astype(np.float32)
              for k, v in p0.items()}
        ref = {}
        for mesh in ((1, 2), (1, 1)):
            _, (a, _, _) = _reference_round(rcfg, arrays, users, mesh, 3, params=p0)
            _, (b, _, _) = _reference_round(rcfg, arrays, users, mesh, 3, params=p1)
            ref[mesh] = a
            rows.append({"images": n_img, "mesh": list(mesh), "what": "reference vs reference "
                         "from a 1e-6 perturbed init",
                         "max_abs": float(np.abs(_flat(a) - _flat(b)).max())})
            print("band", json.dumps(rows[-1]), flush=True)
        N = arrays[0].shape[1]
        perms, _ = reference_draws(jax.random.key(3), users, 1, N)
        aug = _data_aug_draws(jax.random.key(3), users, pcfg["batch_size"]["train"],
                              -(-N // pcfg["batch_size"]["train"]), 2)
        job = dict(kind="grouped", cfg=pcfg, params=p0, data=arrays, users=users, lr=LR,
                   epoch_perms=perms, aug_draws=aug, n_data=2)
        with tempfile.TemporaryDirectory() as tmp:
            outs = run_ranks(dict(kind="seq", deterministic=True, jobs=[job]), 2, tmp)
        rows.append({"images": n_img, "mesh": [1, 2], "what": "port vs reference",
                     "max_abs": float(np.abs(_flat(outs[0]["results"][0]["params"])
                                             - _flat(ref[(1, 2)])).max())})
        print("band", json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
