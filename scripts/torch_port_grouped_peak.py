"""Peak device memory of the grouped engine's audit programs on one GPU,
without the audit's recorder.

    python scripts/torch_port_grouped_peak.py [--root DIR] [--programs NAMES]

Builds each program (default ``grouped/k1,grouped/k2,grouped/k2-map``) as
``heterofl_tpu_torch/staticcheck/audit.py`` does at the flagship widths
(ResNet-18 on the audit's control, one local step a client), dispatches it
twice from the same params, and prints one JSON line: each program's peak
allocated MiB above what was allocated before its first dispatch, which is
what the audit's ``peak_mb`` reads, but with nothing of the round held
between dispatches.  ``--root`` imports the package from another checkout
(an older commit unpacked beside this one), so that two versions are
measured by the same script in one process each, on the same card.
"""

import argparse
import gc
import json
import os
import sys
import tempfile


def main(argv=None) -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here, help="the checkout whose package is measured")
    ap.add_argument("--programs", default="grouped/k1,grouped/k2,grouped/k2-map")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from heterofl_tpu_torch.entry.common import FedExperiment
    from heterofl_tpu_torch.staticcheck import audit

    device = torch.device("cuda")
    peaks = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name in args.programs.split(","):
            spec = next(p for p in audit.PROGRAMS if p.name == name)
            gc.collect()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            cfg = audit.default_audit_cfg(True, "cuda", lm=spec.lm, output_dir=out_dir,
                                          strategy=spec.strategy, superstep_rounds=spec.k,
                                          **spec.over)
            exp = FedExperiment(cfg, 0)
            exp.stage(*exp.make_splits())
            P0 = exp.engine.flatten(exp.model.params())
            torch.cuda.synchronize(device)
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            for _ in range(2):
                audit._dispatch(exp, spec, P0)
            torch.cuda.synchronize(device)
            peaks[name] = round((torch.cuda.max_memory_allocated(device) - base) / 2 ** 20, 3)
            del exp, P0
    print(json.dumps({"root": os.path.relpath(os.path.abspath(args.root), here),
                      "peak_mib": peaks}), flush=True)


if __name__ == "__main__":
    main()
