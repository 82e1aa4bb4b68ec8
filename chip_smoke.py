#!/usr/bin/env python3
"""Proof on one NVIDIA GPU that the PyTorch/CUDA port builds, agrees and
trains.  Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build the CUDA kernels from ``heterofl_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes of ResNet-18's round at batch 10: batch norm forward and backward
   at the four site shapes with zero-weight rows and masked channels, and
   at the MNIST conv twin's and ragged shapes (a NaN in a zero-weight row),
   each call twice and equal bit for bit, with each shape's launch plan; the
   fused masked-SGD epilogue over all 11,172,170 parameters with the clip
   engaged and not, and ``has`` 0 and 1; the int8 codec's quantise-and-pack
   over all 11,172,170 parameters (grid steps from the model's params) at
   (qmax, bias) = (127, 128) and (15, 16), and at an odd n for the tail;
4. time each kernel, its plain version and, where one exists, one PyTorch
   call computing the same function (CUDA events, warm-up, median), and the
   int8 codec's whole step of a round; the batch-norm kernels and their
   library calls also by device time (calls captured in a CUDA graph and
   replayed, so no host work sits between the launches);
5. small rounds on the card against the same rounds on the CPU (plain
   versions), dense and with the int8 codec, then the two main paths:
   ``heterofl_tpu_torch.entry.train_classifier_fed`` with the paper's
   headline control on full-width ResNet-18, synthetic CIFAR10 at its real
   50,000-image train size, ``pallas_norm=1``, ``fused_update=1``, two
   rounds, sBN and Local/Global evaluation after the second -- dense (its
   local epochs cut to ``--dense-local-epochs``, default 1, to keep the
   script's time), then with ``--wire_codec int8`` at the control's 5 local
   epochs; every kernel launch counter is set to 0 just before each path
   and read just after;
6. the ``kernels`` JSON line (launches from the int8 path), then the ``ok``
   JSON line last.

Needs one CUDA device; without one it exits non-zero and prints no result.
Everything it measures is printed on standard output.
"""

from __future__ import annotations

import argparse
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
# BN shapes held against the plain version but not timed (M, C, P): the
# MNIST conv twin of the small rounds (C = 16, 32 at 28x28 and 14x14, batch
# 10); ragged ones (a channel tile cut short, C = 1 and 6 on the kernels'
# scalar path, fewer rows than one block's lanes); and two whose rows do not
# stay in shared memory (the backward's only, then both directions')
BN_CHECK_SHAPES = [(7840, 16, 784), (1960, 32, 196), (999, 20, 111), (50, 1, 5),
                   (37, 48, 37), (3000, 6, 300), (40960, 64, 4096), (131072, 64, 1024)]
BN_GRAPH_CALLS = 20  # calls per CUDA graph when timing device time
LOCAL_EPOCHS = 5  # the control's own, on the int8 main path
ROUNDS = 2
QUANT_CASES = [(127, 128), (15, 16)]  # (qmax, bias): 1 and 8 participants' int8 grids
QUANT_ODD_N = 1001
# stated tolerances of kernel vs plain version (float32, sums in another order)
TOL_BN = {"y": (1e-4, 1e-4), "dx": (1e-4, 1e-4), "dg": (1e-3, 1e-4), "db": (1e-3, 1e-4)}
TOL_SGD_CLIP = (1e-6, 1e-5)   # (atol, rtol) with the clip engaged
TOL_ROUND = 1e-3              # max |params| difference, card round vs CPU round
SHARE_ROUND_INT8 = 0.02       # int8 round: share of entries allowed one grid step apart
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


def graph_ms(fn, calls: int = BN_GRAPH_CALLS, samples: int = 25) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    (warmed up on a side stream first), the median over ``samples`` replays
    on CUDA events, divided by ``calls``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def bn_check(torch, fused_norm, gen, M: int, C: int, P: int, nan_row: bool):
    """Both batch-norm kernels at one shape against their plain versions
    (``TOL_BN``) and against a second call on the same inputs (equal bits).
    With ``nan_row``, a NaN in a zero-weight row of the forward's input must
    stay out of the statistics.  -> (inputs, max errors)"""
    dev = torch.device("cuda")
    N = M // P
    x2 = torch.randn(M, C, device=dev, generator=gen)
    w = torch.ones(N, device=dev)
    zeros = [3, 7] if N == BATCH else [N - 1] if N > 1 else []
    if zeros:
        w[zeros] = 0.0  # zero-weight samples (padding in a short last batch)
    g = torch.randn(C, device=dev, generator=gen)
    b = torch.randn(C, device=dev, generator=gen)
    g[3 * C // 4:] = 0.0
    b[3 * C // 4:] = 0.0  # masked channels of a narrower client
    dy = torch.randn(M, C, device=dev, generator=gen)
    pl = fused_norm.bn_plan(M, C)
    say(f"BN M={M} C={C} P={P}: plan tile_c={pl.tile_c} tiles={pl.tiles} "
        f"cluster={pl.cluster} rows={pl.rows} lanes={pl.lanes} iters={pl.iters} "
        f"resident fwd/bwd={int(pl.resident_fwd)}/{int(pl.resident_bwd)} "
        f"smem fwd/bwd={pl.smem_fwd}/{pl.smem_bwd} B -> {pl.cluster * pl.tiles} blocks")
    xf = x2
    if nan_row and zeros:
        xf = x2.clone()
        xf[zeros[0] * P] = float("nan")
    y_k, st_k = fused_norm.bn_fwd_cuda(xf, w, P, g, b)
    y_p, st_p = fused_norm.bn_fwd_plain(xf, w, P, g, b)
    e_f = max(check_close("bn_fwd y", y_k, y_p, *TOL_BN["y"]),
              check_close("bn_fwd stats", st_k, st_p, *TOL_BN["y"]))
    if not bool(torch.isfinite(st_k).all()):
        raise AssertionError(f"bn_fwd M={M} C={C}: non-finite statistics")
    y_2, st_2 = fused_norm.bn_fwd_cuda(xf, w, P, g, b)
    if xf is not x2:
        st_p = fused_norm.bn_fwd_plain(x2, w, P, g, b)[1]
    dx_k, dg_k, db_k = fused_norm.bn_bwd_cuda(x2, w, P, g, dy, st_p)
    dx_p, dg_p, db_p = fused_norm.bn_bwd_plain(x2, w, P, g, dy, st_p)
    e_b = max(check_close("bn_bwd dx", dx_k, dx_p, *TOL_BN["dx"]),
              check_close("bn_bwd dg", dg_k, dg_p, *TOL_BN["dg"]),
              check_close("bn_bwd db", db_k, db_p, *TOL_BN["db"]))
    again = fused_norm.bn_bwd_cuda(x2, w, P, g, dy, st_p)
    torch.cuda.synchronize()
    if not all(same_bits(torch, a, b) for a, b in zip((y_k, st_k, dx_k, dg_k, db_k),
                                                         (y_2, st_2) + again)):
        raise AssertionError(f"BN M={M} C={C}: two calls on the same inputs differ in their bits")
    say("  bit-identical across two calls: y, stats, dx, dg, db")
    return (x2, w, g, b, dy, st_p), e_f, e_b


def bn_phase(torch, fused_norm):
    """Phases 3 and 4 for the two batch-norm kernels."""
    import torch.nn.functional as F

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms", "bound_ms")
    tot = {k: dict.fromkeys(keys + ("err", "bytes", "ops"), 0.0) for k in ("bn_fwd", "bn_bwd")}
    for M, C, sites in BN_SHAPES:
        P = M // BATCH
        (x2, w, g, b, dy, st_p), e_f, e_b = bn_check(torch, fused_norm, gen, M, C, P, False)
        say(f"  {sites} sites per step")
        # yardstick: PyTorch's own batch norm, all weights 1 (it has no
        # per-sample weight), on the channels_last NCHW view of the rows
        x4 = x2.view(BATCH, 1, P, C).permute(0, 3, 1, 2)
        dy4 = dy.view(BATCH, 1, P, C).permute(0, 3, 1, 2)
        _, s_mean, s_inv = torch.ops.aten.native_batch_norm(x4, g, b, None, None, True, 0.0, 1e-5)
        calls = {
            "bn_fwd": (lambda: fused_norm.bn_fwd_cuda(x2, w, P, g, b),
                       lambda: fused_norm.bn_fwd_plain(x2, w, P, g, b),
                       lambda: F.batch_norm(x4, None, None, g, b, training=True, momentum=0.0,
                                            eps=1e-5)),
            "bn_bwd": (lambda: fused_norm.bn_bwd_cuda(x2, w, P, g, dy, st_p),
                       lambda: fused_norm.bn_bwd_plain(x2, w, P, g, dy, st_p),
                       lambda: torch.ops.aten.native_batch_norm_backward(
                           dy4, x4, g, None, None, s_mean, s_inv, True, 1e-5,
                           [True, True, True])),
        }
        # least bytes: each input read once, each output written once
        nbytes = {"bn_fwd": 4 * (2 * M * C + BATCH + 2 * C + 3 * C),
                  "bn_bwd": 4 * (3 * M * C + BATCH + C + 3 * C + 2 * C)}
        nops = {"bn_fwd": 9 * M * C, "bn_bwd": 14 * M * C}
        for k, (kern, plain, lib) in calls.items():
            t = {"ms": time_ms(kern), "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
                 "device_ms": graph_ms(kern), "library_device_ms": graph_ms(lib),
                 "bound_ms": max(nbytes[k] / BW, nops[k] / F32) * 1e3}
            say(f"  {k}: call {t['ms'] * 1e3:.2f} us (library {t['library_ms'] * 1e3:.2f}, "
                f"plain {t['plain_ms'] * 1e3:.2f}); device {t['device_ms'] * 1e3:.2f} us "
                f"(library {t['library_device_ms'] * 1e3:.2f}); bound {t['bound_ms'] * 1e3:.2f} us")
            r = tot[k]
            for key in keys:
                r[key] += sites * t[key]
            r["bytes"] += sites * nbytes[k]
            r["ops"] += sites * nops[k]
        tot["bn_fwd"]["err"] = max(tot["bn_fwd"]["err"], e_f)
        tot["bn_bwd"]["err"] = max(tot["bn_bwd"]["err"], e_b)
    for M, C, P in BN_CHECK_SHAPES:
        _, e_f, e_b = bn_check(torch, fused_norm, gen, M, C, P, True)
        tot["bn_fwd"]["err"] = max(tot["bn_fwd"]["err"], e_f)
        tot["bn_bwd"]["err"] = max(tot["bn_bwd"]["err"], e_b)
    sites = sum(s for _, _, s in BN_SHAPES)
    for k, r in tot.items():
        say(f"{k}, a training step ({sites} sites): call {r['ms']:.4f} ms (library "
            f"{r['library_ms']:.4f}), device {r['device_ms']:.4f} ms (library "
            f"{r['library_device_ms']:.4f}), {r['device_ms'] / sites * 1e3:.2f} us a site; "
            f"bound {r['bound_ms']:.4f} ms")
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


def quant_phase(torch, quant, codecs, spec, P):
    """Phases 3 and 4 for the int8 codec's quantise-and-pack kernel: the
    values to quantise are drawn around the grid that ``Int8Codec`` derives
    from ``P`` (a cohort of 10), wide enough that some clip.  Also times the
    whole one-GPU codec step of a round (``compressed_sum``: grid, encode
    through the kernel, decode), the int8 round's cost over a dense one."""
    dev = P.device
    n = spec.total
    gen = torch.Generator(device=dev).manual_seed(3)
    u = torch.rand(n, generator=gen, device=dev)
    z = torch.randn(n, generator=gen, device=dev)
    say(f"quant_pack n={n}")
    worst, timed = 0.0, None
    for (qmax, bias), parts in zip(QUANT_CASES, (1, 8)):
        codec = codecs.Int8Codec(spec, parts)
        assert (codec.qmax, codec.bias) == (qmax, bias)
        s = codec.scale_flat(P, 10)
        x = z * s * (qmax / 2.0)
        for m in (n, QUANT_ODD_N):
            w_k, q_k = quant.quant_pack_cuda(x[:m], s[:m], u[:m], qmax, bias)
            w_p, q_p = quant.quant_pack_plain(x[:m], s[:m], u[:m], qmax, bias)
            torch.cuda.synchronize()
            what = f"n={m} qmax={qmax}"
            # an integer and float elementwise chain in the same order: equal bits
            worst = max(worst, check_close(f"quant_pack q {what}", q_k, q_p, 0.0, 0.0),
                        check_close(f"quant_pack words {what}", w_k, w_p, 0.0, 0.0))
            if m == n:
                clipped = float((q_k.abs() == qmax).float().mean())
                say(f"  qmax={qmax}: {100 * clipped:.2f}% of the values clipped")
        if timed is None:
            timed = (x, s, qmax, bias)
    x, s, qmax, bias = timed
    ms = time_ms(lambda: quant.quant_pack_cuda(x, s, u, qmax, bias), reps=5, samples=21)
    pms = time_ms(lambda: quant.quant_pack_plain(x, s, u, qmax, bias), reps=2, samples=11)
    nbytes = 17 * n  # read x, s, u; write q and the words
    nops = 10 * n
    bound = max(nbytes / BW, nops / F32) * 1e3
    say(f"  quant_pack: kernel {ms:.4f} ms  plain {pms:.4f} ms  bound {bound:.4f} ms "
        f"({nbytes / 1e6:.1f} MB)  library: no one PyTorch call")
    codec = codecs.Int8Codec(spec, 1)
    counts = torch.full((n,), 10.0, device=dev)
    resid = torch.zeros((1, n), device=dev)
    cms = time_ms(lambda: codecs.compressed_sum(codec, P, x, counts, resid, u, 10),
                  reps=2, samples=11)
    say(f"  int8 codec step of a round (compressed_sum, cohort of 10): {cms:.4f} ms")
    return {"ms": ms, "plain_ms": pms, "bound_ms": bound, "err": worst, "bytes": nbytes,
            "ops": nops, "library_ms": None}


def small_round_phase(torch, wire_codec):
    """One small round of the port on the card (kernels) against the same
    round on the CPU (plain versions): MNIST conv twin, epoch permutations
    (and the int8 codec's noise) injected so both sides see the same draws.
    Dense: params within ``TOL_ROUND``.  int8: the trained sums differ by
    float rounding, so entries may land one grid step apart: params within
    ``TOL_ROUND`` but a share ``SHARE_ROUND_INT8`` within one step
    ``s / count``, the residual within ``4 x TOL_ROUND`` but that share
    within one step ``s``."""
    import numpy as np

    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.data import (fetch_dataset, label_split_masks, split_dataset,
                                         stack_client_shards)
    from heterofl_tpu_torch.fed import to_width_rates
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import RoundEngine
    from heterofl_tpu_torch.testing import assert_grid_close

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name("1_4_1_iid_fix_a1-b1-c1-e1_bn_1_1")
    cfg["data_name"], cfg["model_name"], cfg["pallas_norm"] = "MNIST", "conv", True
    cfg["wire_codec"] = wire_codec
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
    users = [0, 1, 2, 3]
    out = []  # the card's round, then the CPU's
    for dev in (torch.device("cuda"), torch.device("cpu")):
        model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
        eng = RoundEngine(model, cfg, dev)
        data = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        P = eng.flatten(model.params())
        noise = None
        if eng.codec is not None:
            noise = torch.rand(eng.spec.total, generator=torch.Generator().manual_seed(5))
            noise = noise.to(dev)
        new, ms = eng.train_round(P, 0.05, users, data, 0, epoch_perms=perms,
                                  codec_noise=noise)
        out.append((new.cpu(), ms["loss_sum"].cpu(), eng.wire_resid_host()))
        if eng.codec is not None:
            counts = sum(eng.count_mask_flat(float(wr), data[3][u]).cpu() for u, wr in
                         zip(users, to_width_rates(eng.fix_rates[users], cfg)))
            s = eng.codec.scale_flat(P, len(users)).cpu()
    card, cpu = out
    dl = float((card[1] - cpu[1]).abs().max())
    what = f"small round ({wire_codec}), card vs CPU"
    if wire_codec == "dense":
        d = float((card[0] - cpu[0]).abs().max())
        say(f"{what}: max |params diff| {d:.3e}, max |loss_sum diff| {dl:.3e} "
            f"(tolerance {TOL_ROUND:g})")
        ok = d <= TOL_ROUND
    else:
        assert_grid_close(f"{what}: params", card[0], cpu[0],
                          torch.where(counts > 0, s / counts.clamp_min(1), 0.0),
                          atol=TOL_ROUND, max_share=SHARE_ROUND_INT8)
        assert_grid_close(f"{what}: residual", card[2], cpu[2], s,
                          atol=len(users) * TOL_ROUND, max_share=SHARE_ROUND_INT8)
        say(f"{what}: max |loss_sum diff| {dl:.3e}")
        ok = bool(np.any(card[2] != 0))
    if not (ok and math.isfinite(dl) and dl <= 100 * TOL_ROUND):
        raise AssertionError(f"{what}: the round on the card disagrees with the round on the CPU")


def main_path(torch, counters, codec: str, local_epochs: int):
    """``train_classifier_fed`` on the headline control for ``ROUNDS``
    rounds with evaluation after the last, the launch counters set to 0
    just before and read just after -> (launches, result, seconds)."""
    from heterofl_tpu_torch.entry import train_classifier_fed

    argv = ["--control_name", HEADLINE, "--synthetic", "1",
            "--synthetic_sizes", json.dumps({"train": 50000, "test": 10000}),
            "--pallas_norm", "1", "--fused_update", "1", "--wire_codec", codec,
            "--eval_interval", str(ROUNDS),
            "--override", json.dumps({"num_epochs": {"global": ROUNDS, "local": local_epochs}})]
    say(f"main path ({codec}): train_classifier_fed {' '.join(argv)}")
    for counts in counters:
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    (result,) = train_classifier_fed.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = {k: v for counts in counters for k, v in counts.items()}
    say(f"main path ({codec}): {secs:.1f} s for {ROUNDS} rounds, local epochs {local_epochs}; "
        f"launches {launches}")
    hist = result["history"]
    for r in hist:
        say(f"  round {r['epoch']}: loss {r['loss']:.4f} accuracy {r['accuracy']:.2f}% "
            f"{r['seconds']:.2f} s ({r['n']:.0f} samples)")
    last = hist[-1] if hist else {}
    names = ("Local-Loss", "Local-Accuracy", "Global-Loss", "Global-Accuracy", "eval_seconds")
    if not all(k in last for k in names):
        raise AssertionError(f"main path ({codec}): no evaluation after round {ROUNDS}: {last}")
    say(f"  evaluation after round {last['epoch']}: Local loss {last['Local-Loss']:.4f} "
        f"accuracy {last['Local-Accuracy']:.2f}%, Global loss {last['Global-Loss']:.4f} "
        f"accuracy {last['Global-Accuracy']:.2f}%, {last['eval_seconds']:.2f} s "
        f"(sBN over the train set, then Local, then Global)")
    if len(hist) != ROUNDS or not all(math.isfinite(r["loss"]) for r in hist) \
            or not all(math.isfinite(last[k]) for k in names):
        raise AssertionError(f"main path ({codec}): expected {ROUNDS} finite round losses and "
                             f"finite test metrics, got {hist}")
    return launches, result, secs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dense-local-epochs", type=int, default=1,
                        help="local epochs of the dense main path (the control's own is 5)")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA "
              "device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.compress import codecs
    from heterofl_tpu_torch.models import make_model, param_mask
    from heterofl_tpu_torch.ops import _build, fused_norm, fused_update, quant
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
    P = spec.flatten(dict(model.init_(torch.Generator().manual_seed(0)).named_parameters()))
    qp = quant_phase(torch, quant, codecs, spec, P.detach().cuda())
    del P
    torch.cuda.empty_cache()

    # 5. small rounds against the CPU, then the main paths, each counted
    small_round_phase(torch, "dense")
    small_round_phase(torch, "int8")
    counters = (fused_norm.LAUNCHES, fused_update.LAUNCHES, quant.LAUNCHES)
    dense, _, _ = main_path(torch, counters, "dense", args.dense_local_epochs)
    if dense["quant_pack"] != 0 or min(dense[k] for k in ("bn_fwd", "bn_bwd", "fused_sgd")) <= 0:
        raise AssertionError(f"dense main path: unexpected launches {dense}")
    launches, result, _ = main_path(torch, counters, "int8", LOCAL_EPOCHS)
    if launches["quant_pack"] != ROUNDS:
        raise AssertionError(f"int8 main path: quant_pack launched {launches['quant_pack']} "
                             f"times, expected one per round ({ROUNDS})")
    params = result["params"]
    if set(params) != set(spec.names) or any(
            tuple(v.shape) != spec.shapes[k] or not bool(torch.isfinite(v).all())
            for k, v in params.items()):
        raise AssertionError("main path: new global params are not finite at the model's shapes")
    resid = result["wire_resid"]
    if resid.shape != (1, spec.total) or not np.isfinite(resid).all() or not resid.any():
        raise AssertionError("int8 main path: the error-feedback residual is not a finite, "
                             "non-zero [1, n] carry")

    # 6. the kernels line
    kernels = []
    for name, r, src, repl in (
            ("bn_fwd", bn["bn_fwd"], "heterofl_tpu_torch/csrc/bn.cu",
             "heterofl_tpu/ops/pallas_norm.py:115"),
            ("bn_bwd", bn["bn_bwd"], "heterofl_tpu_torch/csrc/bn.cu",
             "heterofl_tpu/ops/pallas_norm.py:140"),
            ("fused_sgd", sgd, "heterofl_tpu_torch/csrc/fused_sgd.cu",
             "heterofl_tpu/ops/fused_update.py:207"),
            ("quant_pack", qp, "heterofl_tpu_torch/csrc/quant.cu",
             "heterofl_tpu/ops/quant.py:116")):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes" if r["bytes"] / BW >= r["ops"] / F32
                        else "operations",
                        "library_ms": r.get("library_ms")})
        if name.startswith("bn_"):
            kernels[-1].update(device_ms=r["device_ms"], library_device_ms=r["library_device_ms"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
