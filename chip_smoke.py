#!/usr/bin/env python3
"""Proof on one NVIDIA GPU that the PyTorch/CUDA port builds, agrees and
trains.  Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build the CUDA kernels from ``heterofl_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes of ResNet-18's training step at batch 10: batch norm forward and
   backward at the four site shapes with zero-weight rows and masked
   channels; the fused masked-SGD epilogue over all 11,172,170 parameters
   with the clip engaged and not, and ``has`` 0 and 1;
4. time each kernel, its plain version and, for batch norm, one PyTorch
   call computing the same function (CUDA events, warm-up, median);
5. a small round on the card against the same round on the CPU (plain
   versions), then the main path: ``heterofl_tpu_torch.entry.
   train_classifier_fed`` with the paper's headline control on full-width
   ResNet-18, synthetic CIFAR10 at its real 50,000-image train size,
   ``pallas_norm=1``, ``fused_update=1``, two rounds -- with every kernel
   launch counter set to 0 just before and read just after;
6. the ``kernels`` JSON line, then the ``ok`` JSON line last.

Needs one CUDA device; without one it exits non-zero and prints no result.
Everything it measures is printed on standard output.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
BATCH = 10
# ResNet-18 on 32x32 CIFAR at batch 10: (rows M = N*H*W, channels C, BN
# sites of that shape per training step) -- 17 sites per step
BN_SHAPES = [(10240, 64, 5), (2560, 128, 4), (640, 256, 4), (160, 512, 4)]
LOCAL_EPOCHS = 5  # the control's own; cut to 1 only if a round outgrows the budget
ROUNDS = 2
# stated tolerances of kernel vs plain version (float32, sums in another order)
TOL_BN = {"y": (1e-4, 1e-4), "dx": (1e-4, 1e-4), "dg": (1e-3, 1e-4), "db": (1e-3, 1e-4)}
TOL_SGD_CLIP = (1e-6, 1e-5)   # (atol, rtol) with the clip engaged
TOL_ROUND = 1e-3              # max |params| difference, card round vs CPU round
# published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device-memory rate and float32 rate outside the tensor cores; the card's
# name and power limit are printed beside every number
BW = 3.35e12
F32 = 67e12


def say(msg: str) -> None:
    print(msg, flush=True)


def check_close(what, a, b, atol, rtol) -> float:
    """Kernel result ``a`` against the plain version's ``b``: prints the
    largest differences, raises beyond the tolerance, returns the largest
    absolute difference."""
    from heterofl_tpu_torch.testing import assert_close

    return assert_close(what, a, b, rtol=rtol, atol=atol)[0]


def time_ms(fn, reps: int = 10, samples: int = 25, warmup: int = 3) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    calls, on CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def bn_phase(torch, fused_norm):
    """Phases 3 and 4 for the two batch-norm kernels."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
               "bytes": 0.0, "ops": 0.0} for k in ("bn_fwd", "bn_bwd")}
    for M, C, sites in BN_SHAPES:
        P = M // BATCH
        x2 = torch.randn(M, C, device=dev, generator=gen)
        w = torch.ones(BATCH, device=dev)
        w[3] = 0.0
        w[7] = 0.0  # two zero-weight samples (padding in a short last batch)
        g = torch.randn(C, device=dev, generator=gen)
        b = torch.randn(C, device=dev, generator=gen)
        g[3 * C // 4:] = 0.0
        b[3 * C // 4:] = 0.0  # masked channels of a narrower client
        dy = torch.randn(M, C, device=dev, generator=gen)
        say(f"BN M={M} C={C} ({sites} sites per step)")
        y_k, st_k = fused_norm.bn_fwd_cuda(x2, w, P, g, b)
        y_p, st_p = fused_norm.bn_fwd_plain(x2, w, P, g, b)
        e_f = max(check_close("bn_fwd y", y_k, y_p, *TOL_BN["y"]),
                  check_close("bn_fwd stats", st_k, st_p, *TOL_BN["y"]))
        dx_k, dg_k, db_k = fused_norm.bn_bwd_cuda(x2, w, P, g, dy, st_p)
        dx_p, dg_p, db_p = fused_norm.bn_bwd_plain(x2, w, P, g, dy, st_p)
        e_b = max(check_close("bn_bwd dx", dx_k, dx_p, *TOL_BN["dx"]),
                  check_close("bn_bwd dg", dg_k, dg_p, *TOL_BN["dg"]),
                  check_close("bn_bwd db", db_k, db_p, *TOL_BN["db"]))
        torch.cuda.synchronize()
        # yardstick: PyTorch's own batch norm, all weights 1 (it has no
        # per-sample weight), on the channels_last NCHW view of the rows
        x4 = x2.view(BATCH, 1, P, C).permute(0, 3, 1, 2)
        dy4 = dy.view(BATCH, 1, P, C).permute(0, 3, 1, 2)
        _, s_mean, s_inv = torch.ops.aten.native_batch_norm(x4, g, b, None, None, True, 0.0, 1e-5)
        t = {
            "bn_fwd": (time_ms(lambda: fused_norm.bn_fwd_cuda(x2, w, P, g, b)),
                       time_ms(lambda: fused_norm.bn_fwd_plain(x2, w, P, g, b)),
                       time_ms(lambda: F.batch_norm(x4, None, None, g, b, training=True,
                                                    momentum=0.0, eps=1e-5))),
            "bn_bwd": (time_ms(lambda: fused_norm.bn_bwd_cuda(x2, w, P, g, dy, st_p)),
                       time_ms(lambda: fused_norm.bn_bwd_plain(x2, w, P, g, dy, st_p)),
                       time_ms(lambda: torch.ops.aten.native_batch_norm_backward(
                           dy4, x4, g, None, None, s_mean, s_inv, True, 1e-5,
                           [True, True, True]))),
        }
        # least bytes: each input read once, each output written once
        nbytes = {"bn_fwd": 4 * (2 * M * C + BATCH + 2 * C + 3 * C),
                  "bn_bwd": 4 * (3 * M * C + BATCH + C + 3 * C + 2 * C)}
        nops = {"bn_fwd": 9 * M * C, "bn_bwd": 14 * M * C}
        for k, (ms, pms, lms) in t.items():
            bound = max(nbytes[k] / BW, nops[k] / F32) * 1e3
            say(f"  {k}: kernel {ms:.4f} ms  plain {pms:.4f} ms  library {lms:.4f} ms  "
                f"bound {bound * 1e3:.2f} us")
            r = tot[k]
            r["ms"] += sites * ms
            r["plain_ms"] += sites * pms
            r["library_ms"] += sites * lms
            r["bound_ms"] += sites * bound
            r["bytes"] += sites * nbytes[k]
            r["ops"] += sites * nops[k]
        tot["bn_fwd"]["err"] = max(tot["bn_fwd"]["err"], e_f)
        tot["bn_bwd"]["err"] = max(tot["bn_bwd"]["err"], e_b)
    return tot


def sgd_phase(torch, fused_update, mask_flat):
    """Phases 3 and 4 for the fused masked-SGD kernel."""
    dev = torch.device("cuda")
    n = mask_flat.numel()
    gen = torch.Generator(device=dev).manual_seed(1)
    p0 = torch.randn(n, device=dev, generator=gen) * mask_flat
    b0 = torch.randn(n, device=dev, generator=gen) * 0.1 * mask_flat
    graw = torch.randn(n, device=dev, generator=gen)
    kw = dict(momentum=0.9, weight_decay=5e-4, max_norm=1.0)
    worst = 0.0
    say(f"fused SGD n={n}")
    for clip in (False, True):
        # the clip engages when ||(g / denom) * mask|| > 1
        g = graw * (1.0 if clip else 1e-5)
        for has in (1.0, 0.0):
            scal = torch.tensor([7.0, 0.1, has], device=dev)
            p_ref, b_ref = fused_update.fused_sgd_plain(g, p0, b0, mask_flat, scal, **kw)
            p_k, b_k = p0.clone(), b0.clone()
            fused_update.fused_sgd_cuda(g, p_k, b_k, mask_flat, scal, **kw)
            torch.cuda.synchronize()
            what = f"clip={'on' if clip else 'off'} has={int(has)}"
            # without the clip the elementwise tail is the same arithmetic in
            # the same order: equal values; with it the norm is summed in
            # another order
            tol = TOL_SGD_CLIP if clip and has else (0.0, 0.0)
            worst = max(worst, check_close(f"fused_sgd p {what}", p_k, p_ref, *tol),
                        check_close(f"fused_sgd buf {what}", b_k, b_ref, *tol))
            dead = mask_flat == 0  # a narrower level's rows stay zero
            if bool((p_k[dead] != 0).any()) or bool((b_k[dead] != 0).any()):
                raise AssertionError(f"fused_sgd {what}: masked entries moved off zero")
    scal = torch.tensor([7.0, 0.1, 1.0], device=dev)
    p_k, b_k = p0.clone(), b0.clone()
    ms = time_ms(lambda: fused_update.fused_sgd_cuda(graw, p_k, b_k, mask_flat, scal, **kw),
                 reps=5, samples=21)
    pms = time_ms(lambda: fused_update.fused_sgd_plain(graw, p0, b0, mask_flat, scal, **kw),
                  reps=2, samples=21)
    nbytes = 6 * 4 * n
    bound = max(nbytes / BW, 10 * n / F32) * 1e3
    say(f"  fused_sgd: kernel {ms:.4f} ms  plain {pms:.4f} ms  bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "plain_ms": pms, "bound_ms": bound, "err": worst,
            "bytes": nbytes, "ops": 10 * n}


def small_round_phase(torch):
    """One small round of the port on the card (kernels) against the same
    round on the CPU (plain versions): MNIST conv twin, epoch permutations
    injected so both sides see the same batches."""
    import numpy as np

    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.data import (fetch_dataset, label_split_masks, split_dataset,
                                         stack_client_shards)
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import RoundEngine

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name("1_4_1_iid_fix_a1-b1-c1-e1_bn_1_1")
    cfg["data_name"], cfg["model_name"], cfg["pallas_norm"] = "MNIST", "conv", True
    cfg["override"] = {"num_epochs": {"local": 2}, "conv": {"hidden_size": [16, 32]}}
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    ds = fetch_dataset("MNIST", synthetic=True, synthetic_sizes={"train": 400, "test": 40})
    split, lsplit = split_dataset(ds, 4, "iid", np.random.default_rng(0), classes_size=10)
    arrays = stack_client_shards(ds["train"].data, ds["train"].target, split["train"],
                                 list(range(4))) + (label_split_masks(lsplit, 4, 10),)
    rng = np.random.default_rng(2)
    perms = {u: np.stack([rng.permutation(arrays[0].shape[1]) for _ in range(2)])
             for u in range(4)}
    out = {}
    for dev in (torch.device("cuda"), torch.device("cpu")):
        model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
        eng = RoundEngine(model, cfg, dev)
        data = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        new, ms = eng.train_round(eng.flatten(model.params()), 0.05, [0, 1, 2, 3], data, 0,
                                  epoch_perms=perms)
        out[dev.type] = (new.cpu(), ms["loss_sum"].cpu())
    d = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    dl = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    say(f"small round, card vs CPU: max |params diff| {d:.3e}, max |loss_sum diff| {dl:.3e} "
        f"(tolerance {TOL_ROUND:g})")
    if not (d <= TOL_ROUND and math.isfinite(dl) and dl <= 100 * TOL_ROUND):
        raise AssertionError("the round on the card disagrees with the round on the CPU")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA "
              "device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.models import make_model, param_mask
    from heterofl_tpu_torch.ops import _build, fused_norm, fused_update
    from heterofl_tpu_torch.ops.fused_update import FlatSpec

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    say(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    say(smi)

    # 2. build
    t0 = time.time()
    _build.load()
    build_s = time.time() - t0
    say(f"kernels built in {build_s:.1f} s -> {_build.BUILD_INFO['library']}")
    for line in str(_build.BUILD_INFO.get("ptxas", "")).splitlines():
        if "Used" in line or "Compiling entry" in line:
            say("  " + line.strip())

    # 3-4. kernels against their plain versions, then timed
    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(HEADLINE)
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    model = make_model(cfg)
    spec = FlatSpec.of(dict(model.named_parameters()))
    mask_flat = spec.flatten({k: param_mask(s, model.specs[k], model.groups, 0.25)
                              for k, s in spec.shapes.items()}).cuda()
    bn = bn_phase(torch, fused_norm)
    sgd = sgd_phase(torch, fused_update, mask_flat)
    del mask_flat
    torch.cuda.empty_cache()

    # 5. a small round against the CPU, then the main path, counted
    small_round_phase(torch)
    from heterofl_tpu_torch.entry import train_classifier_fed

    argv = ["--control_name", HEADLINE, "--synthetic", "1",
            "--synthetic_sizes", json.dumps({"train": 50000, "test": 10000}),
            "--pallas_norm", "1", "--fused_update", "1",
            "--override", json.dumps({"num_epochs": {"global": ROUNDS, "local": LOCAL_EPOCHS}})]
    say(f"main path: train_classifier_fed {' '.join(argv)}")
    for counts in (fused_norm.LAUNCHES, fused_update.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    (result,) = train_classifier_fed.main(argv)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = {**fused_norm.LAUNCHES, **fused_update.LAUNCHES}
    say(f"main path: {main_s:.1f} s for {ROUNDS} rounds, local epochs {LOCAL_EPOCHS}; "
        f"launches {launches}")
    hist = result["history"]
    for r in hist:
        say(f"  round {r['epoch']}: loss {r['loss']:.4f} accuracy {r['accuracy']:.2f}% "
            f"{r['seconds']:.2f} s ({r['n']:.0f} samples)")
    if len(hist) != ROUNDS or not all(math.isfinite(r["loss"]) for r in hist):
        raise AssertionError(f"main path: expected {ROUNDS} finite round losses, got {hist}")
    params = result["params"]
    if set(params) != set(spec.names) or any(
            tuple(v.shape) != spec.shapes[k] or not bool(torch.isfinite(v).all())
            for k, v in params.items()):
        raise AssertionError("main path: new global params are not finite at the model's shapes")

    # 6. the kernels line
    kernels = []
    for name, r, src, repl in (
            ("bn_fwd", bn["bn_fwd"], "heterofl_tpu_torch/csrc/bn.cu",
             "heterofl_tpu/ops/pallas_norm.py:115"),
            ("bn_bwd", bn["bn_bwd"], "heterofl_tpu_torch/csrc/bn.cu",
             "heterofl_tpu/ops/pallas_norm.py:140"),
            ("fused_sgd", sgd, "heterofl_tpu_torch/csrc/fused_sgd.cu",
             "heterofl_tpu/ops/fused_update.py:207")):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes" if r["bytes"] / BW >= r["ops"] / F32
                        else "operations",
                        "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
