#!/usr/bin/env python3
"""Proof on one NVIDIA GPU that the PyTorch/CUDA port builds, agrees and
trains.  Run from the repository root:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero);
each prints its seconds:

1. the device: ``torch.cuda.get_device_name`` and ``nvidia-smi``'s name and
   power limit;
2. build the CUDA kernels from ``heterofl_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold every kernel against its plain PyTorch version on the card, at the
   shapes of ResNet-18's round at batch 10 and of its centralised epoch at
   batch 100, and of a ResNet-50 step at batch 10 (its 11 distinct site
   shapes, C up to 2048; the fused SGD at its 23,513,162 parameters):
   batch norm forward and backward at the site shapes with
   zero-weight rows and masked channels, and at the MNIST conv twin's and
   ragged shapes (a NaN in a zero-weight row), each call twice and equal
   bit for bit, with each shape's launch plan; the fused masked-SGD
   epilogue over all 11,172,170 parameters with the clip engaged and not,
   and ``has`` 0 and 1; the int8 codec's quantise-and-pack over all
   11,172,170 parameters (grid steps from the model's params) at (qmax,
   bias) = (127, 128) and (15, 16), and at an odd n for the tail;
4. time each kernel, its plain version and, where one exists, one PyTorch
   call computing the same function (CUDA events, warm-up, median), and the
   int8 codec's whole step of a round; every kernel and the batch-norm
   library calls also by device time (calls captured in a CUDA graph and
   replayed, so no host work sits between the launches);
5. small rounds on the card against the same rounds on the CPU (plain
   versions), dense and with the int8 codec, and dense under the ``in``,
   ``ln`` and ``gn`` norms; one ResNet-50 round at full width (levels a and
   e, 2 steps each) against the CPU, and its local step timed; then the
   main paths, each into a fresh temporary ``output_dir``:
   ``heterofl_tpu_torch.entry.train_classifier_fed`` with the paper's
   headline control on full-width ResNet-18, synthetic CIFAR10 at half its
   real 50,000-image train size, ``pallas_norm=1``, ``fused_update=1``, one
   round (``ROUNDS``) with a checkpoint, sBN and Local/Global evaluation,
   local epochs cut to ``--local-epochs`` (default 1; the control's own is
   5) to keep the script's time -- dense, then with ``--wire_codec
   int8``; after each, the same entry with one more
   round and ``--resume_mode 1`` must train exactly that round, from params
   (and the int8 residual) equal to the checkpoint's bit for bit; then
   ``test_classifier_fed`` on the int8 path's best checkpoint must
   reproduce the Global loss and accuracy its training log holds; then the
   centralised baseline, ``train_classifier`` (one epoch at batch 100 on the
   same data, ``pallas_norm=1``) and ``test_classifier``.  Then the sixth
   slice's paths on dataset files written in their real formats into a
   temporary ``data_dir`` from a seed: (a) CIFAR10 as python-pickle
   batches and EMNIST balanced as gzip IDX, read back through
   ``fetch_dataset`` and checked against what was written; (b)
   ``train_classifier_fed`` with the ``dynamic`` control ``DYNAMIC`` on the
   CIFAR10 files, full-width ResNet-18, two rounds (every drawn rate a mode
   rate, each client's params zero outside its width, launches the steps
   times the sites) and round 2 again from the round-1 checkpoint, drawing
   the uninterrupted run's rates; (c) EMNIST on the conv net at full width
   under ``gn`` with statistics computed, cached and read back (no BN
   launch).  Every kernel
   launch counter is set to 0 just before each path and read just after;
   each checkpoint write and best copy prints its seconds and megabytes;
6. the masked LM: the fused masked-SGD epilogue and the
   quantise-and-pack held and timed again at the full-width transformer's
   2,454,528 parameters (the level-e per-head width mask); one LM round of
   a level-a and a level-e client on the card against the same round on the
   CPU (draws made on the CPU and injected); then
   ``train_transformer_fed`` with ``LM_CONTROL`` at full width (E 256, 8
   heads, FFN 512, 4 layers, bptt 64) on synthetic WikiText2 at its quoted
   2,088,628 / 245,569 tokens -- three rounds of 327 local steps each, a
   checkpoint and a Global evaluation (384 windows of [10, 64]) each
   round; the same entry resumed for a fourth round (``--resume_mode 1``,
   from the checkpoint's params bit for bit); ``test_transformer_fed``
   reproducing the best checkpoint's logged Global-Perplexity; one int8
   round; the centralised ``train_transformer`` (one epoch of 327 steps of
   [100, 64]) and ``test_transformer``.  The ``<mask>`` row of the token
   embedding must keep its initial value through every round, and no LM
   path may launch a batch-norm kernel;
7. the grouped engine (``--strategy grouped``): the batched batch-norm
   kernels held against their plain version at ResNet-18's site shapes for
   every level and G in {1, 2, 4} (at level e a channel tile holds several
   clients; a padding sample with a NaN) and timed over a step at G = 2,
   levels a and e; the batched fused SGD at ``[G, n_l]`` for levels a and e,
   each row bit for bit the one-client kernel's; small grouped rounds (conv
   net, ResNet-18 at 8/16/16/16) on the card against the CPU, the sliced
   twin and the masked engine, and a full-width grouped LM round of two
   level-b clients against the CPU and, at dropout 0, the masked engine;
   the headline control's first ``TIMED_ROUNDS`` rounds under the masked
   and the grouped engine in turns, on the control's own cohorts;
   ``train_classifier_fed --strategy grouped`` on the headline control,
   ``GROUPED_ROUNDS`` rounds of two clients a level (the batched kernels'
   launches asserted, no one-client kernel), its last round resumed equal
   bit for bit as the entry runs it; one grouped LM round of the entry;
8. the ``kernels`` JSON line (launches from the int8 path, the batched
   kernels' from the grouped path; per path in ``launches_by_path``), then
   the ``ok`` JSON line last.

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
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
TAG = f"0_CIFAR10_label_resnet18_{HEADLINE}"
CENTRAL = "1_1_1_none_fix_a1_bn_1_1"  # the centralised baseline, full width
CENTRAL_TAG = f"0_CIFAR10_label_resnet18_{CENTRAL}"
CENTRAL_EPOCHS = 1
# the vision paths' synthetic CIFAR10: half the real 50,000-image train set
# (250 steps a round, 2,500 sBN forwards; cut for the script's time),
# the real 10,000-image test set
SIZES = {"train": 25000, "test": 10000}
BATCH = 10
CENTRAL_BATCH = 100
# ResNet-18 on 32x32 CIFAR at batch 10: (rows M = N*H*W, channels C, BN
# sites of that shape per training step) -- 17 sites per step
BN_SHAPES = [(10240, 64, 5), (2560, 128, 4), (640, 256, 4), (160, 512, 4)]
BN_SITES = sum(s for _, _, s in BN_SHAPES)
# the same sites at the centralised baseline's batch 100
BN_CENTRAL_SHAPES = [(10 * M, C, s) for M, C, s in BN_SHAPES]
# BN shapes held against the plain version but not timed (M, C, P): the
# MNIST conv twin of the small rounds (C = 16, 32 at 28x28 and 14x14, batch
# 10); ragged ones (a channel tile cut short, C = 1 and 6 on the kernels'
# scalar path, fewer rows than one block's lanes); and two whose rows do not
# stay in shared memory (the backward's only, then both directions')
BN_CHECK_SHAPES = [(7840, 16, 784), (1960, 32, 196), (999, 20, 111), (50, 1, 5),
                   (37, 48, 37), (3000, 6, 300), (40960, 64, 4096), (131072, 64, 1024)]
BN_GRAPH_CALLS = 20  # calls per CUDA graph when timing device time
ROUNDS = 1  # the vision main paths' rounds before the resumed one (cut from 2 for time)
QUANT_CASES = [(127, 128), (15, 16)]  # (qmax, bias): 1 and 8 participants' int8 grids
QUANT_ODD_N = 1001
# stated tolerances of kernel vs plain version (float32, sums in another order)
TOL_BN = {"y": (1e-4, 1e-4), "dx": (1e-4, 1e-4), "dg": (1e-3, 1e-4), "db": (1e-3, 1e-4)}
TOL_SGD_CLIP = (1e-6, 1e-5)   # (atol, rtol) with the clip engaged
TOL_ROUND = 1e-3              # max |params| difference, card round vs CPU round
SHARE_ROUND_INT8 = 0.02       # int8 round: share of entries allowed one grid step apart
# a checkpoint evaluated again against the value its training log holds
# (the same params and data; cuDNN may pick other algorithms in another
# process): loss within 1e-4 relative, accuracy within 0.05 points (5 of
# the 10,000 test images)
TOL_EVAL_LOSS = 1e-4
TOL_EVAL_ACC = 0.05
# the masked LM: the control of the paper's WikiText2 runs, full width;
# synthetic WikiText2 at the token counts quoted for WikiText2
LM_CONTROL = "1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
LM_TAG = f"0_WikiText2_label_transformer_{LM_CONTROL}"
LM_CENTRAL_TAG = f"0_WikiText2_label_transformer_{CENTRAL}"
LM_SIZES = {"train": 2088628, "test": 245569}
LM_N = 2454528          # the full-width transformer's parameters (vocabulary 512)
LM_STEPS = 327          # ceil(20,886 tokens a user / bptt 64)
LM_ROUNDS = 3
# the card-vs-CPU LM rounds: (user, tokens of its row): level a over 10
# windows, level e over 2 (lm_round_phase says why)
LM_ROUND_CLIENTS = ((0, 640), (99, 128))
TOL_LM_ROUND = 1e-3     # max |params| difference, card LM round vs CPU LM round
# the sixth slice: dynamic rates on data read from disk, the group norms and
# the bottleneck ResNet.  The dataset files are written in their real
# on-disk formats from a seed: CIFAR10 as the python-pickle batches, cut in
# depth to the vision paths' 25,000 training images (five batches of 5,000)
# and the real 10,000 test images; EMNIST balanced as gzip IDX, cut from
# 112,800 / 18,800 images to EMNIST_SIZES.
DYNAMIC = "1_100_0.1_iid_dynamic_a1-b1-c1-d1-e1_bn_1_1"
DYN_TAG = f"0_CIFAR10_label_resnet18_{DYNAMIC}"
DYN_ROUNDS = 2
MODE_RATES = {1.0, 0.5, 0.25, 0.125, 0.0625}
CIFAR_BATCH_ROWS = 5000
EMNIST_CONTROL = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_gn_1_1"
EMNIST_TAG = f"0_EMNIST_label_conv_{EMNIST_CONTROL}"
EMNIST_SIZES = {"train": 24000, "test": 4000}
SMALL_NORMS = ("in", "ln", "gn")
# the grouped engine (seventh slice): the batched kernels' counters, zero on
# every other path
NO_BATCHED = {"bn_fwd_batched": 0, "bn_bwd_batched": 0, "fused_sgd_batched": 0}
LEVELS = (1.0, 0.5, 0.25, 0.125, 0.0625)
GROUPED_G = (1, 2, 4)                           # clients batched, held at every level
GROUPED_TIMED = ((2, 1.0), (2, 0.0625))          # (G, rate) of the timed batched steps
GROUPED_ROUNDS = 2  # pinned cohorts: round 1, then round 2, which is resumed
TIMED_ROUNDS = 8    # masked and grouped rounds in turns, the control's own cohorts
# the grouped LM round on the card: two level-b clients of the LM control
# (users 20 l .. 20 l + 19 are at level l), 4 windows of bptt 64 each
GROUPED_LM_USERS = (20, 21)
GROUPED_LM_TOKENS = 256
TOL_GROUPED = (5e-4, 5e-5)  # (rtol, atol): grouped vs masked and vs sliced (tests/test_grouped.py)
# ResNet-50 at full width on CIFAR10 (23,513,162 parameters, 49 BN sites a
# step); its card-vs-CPU round: a level-a and a level-e client of 20
# samples, 2 steps each (level e is chaotic over more steps; a batch of
# padding only is left out: its loss is not finite on either device)
R50_CONTROL = "1_2_1_iid_fix_a1-e1_bn_1_1"
R50_N = 23513162
R50_SITES = 49
R50_SHARD = 20
R50_TIMED_STEPS = 10
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
    zeros = [3, 7] if N in (BATCH, CENTRAL_BATCH) else [N - 1] if N > 1 else []
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


def bn_phase(torch, fused_norm, r50_shapes):
    """Phases 3 and 4 for the two batch-norm kernels -> per kernel, the
    totals of a training step at batch 10 (the federated ResNet-18 round),
    under ``central_*`` at batch 100 (the centralised epoch), and under
    ``r50_*`` of a ResNet-50 step at batch 10 (``r50_shapes``: its distinct
    ``(M, C, sites)``; each shape's times also under ``r50_by_shape``).  The
    ResNet-50 shapes are timed on fewer samples."""
    import torch.nn.functional as F

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms", "bound_ms")
    tot = {k: dict.fromkeys(keys + ("err", "bytes", "ops"), 0.0) for k in ("bn_fwd", "bn_bwd")}
    for k in tot:
        tot[k]["r50_by_shape"] = []
    for batch, shapes, pre in ((BATCH, BN_SHAPES, ""), (CENTRAL_BATCH, BN_CENTRAL_SHAPES,
                                                          "central_"), (BATCH, r50_shapes, "r50_")):
        n_sites = sum(sites for _, _, sites in shapes)
        few = {"samples": 9} if pre == "r50_" else {}
        for k in tot:
            tot[k].update({pre + key: 0.0 for key in keys + ("bytes", "ops")})
        for M, C, sites in shapes:
            P = M // batch
            (x2, w, g, b, dy, st_p), e_f, e_b = bn_check(torch, fused_norm, gen, M, C, P, False)
            say(f"  {sites} sites per step at batch {batch}")
            # yardstick: PyTorch's own batch norm, all weights 1 (it has no
            # per-sample weight), on the channels_last NCHW view of the rows
            x4 = x2.view(batch, 1, P, C).permute(0, 3, 1, 2)
            dy4 = dy.view(batch, 1, P, C).permute(0, 3, 1, 2)
            _, s_mean, s_inv = torch.ops.aten.native_batch_norm(x4, g, b, None, None, True, 0.0,
                                                                1e-5)
            calls = {
                "bn_fwd": (lambda: fused_norm.bn_fwd_cuda(x2, w, P, g, b),
                           lambda: fused_norm.bn_fwd_plain(x2, w, P, g, b),
                           lambda: F.batch_norm(x4, None, None, g, b, training=True,
                                                momentum=0.0, eps=1e-5)),
                "bn_bwd": (lambda: fused_norm.bn_bwd_cuda(x2, w, P, g, dy, st_p),
                           lambda: fused_norm.bn_bwd_plain(x2, w, P, g, dy, st_p),
                           lambda: torch.ops.aten.native_batch_norm_backward(
                               dy4, x4, g, None, None, s_mean, s_inv, True, 1e-5,
                               [True, True, True])),
            }
            # least bytes: each input read once, each output written once
            nbytes = {"bn_fwd": 4 * (2 * M * C + batch + 2 * C + 3 * C),
                      "bn_bwd": 4 * (3 * M * C + batch + C + 3 * C + 2 * C)}
            nops = {"bn_fwd": 9 * M * C, "bn_bwd": 14 * M * C}
            for k, (kern, plain, lib) in calls.items():
                t = {"ms": time_ms(kern, **few), "plain_ms": time_ms(plain, **few),
                     "library_ms": time_ms(lib, **few), "device_ms": graph_ms(kern, **few),
                     "library_device_ms": graph_ms(lib, **few),
                     "bound_ms": max(nbytes[k] / BW, nops[k] / F32) * 1e3}
                say(f"  {k}: call {t['ms'] * 1e3:.2f} us (library {t['library_ms'] * 1e3:.2f}, "
                    f"plain {t['plain_ms'] * 1e3:.2f}); device {t['device_ms'] * 1e3:.2f} us "
                    f"(library {t['library_device_ms'] * 1e3:.2f}); bound "
                    f"{t['bound_ms'] * 1e3:.2f} us")
                r = tot[k]
                for key in keys:
                    r[pre + key] += sites * t[key]
                r[pre + "bytes"] += sites * nbytes[k]
                r[pre + "ops"] += sites * nops[k]
                if pre == "r50_":
                    r["r50_by_shape"].append({"M": M, "C": C, "sites": sites, **t})
            tot["bn_fwd"]["err"] = max(tot["bn_fwd"]["err"], e_f)
            tot["bn_bwd"]["err"] = max(tot["bn_bwd"]["err"], e_b)
        what = "a ResNet-50 training step" if pre == "r50_" else "a training step"
        for k, r in tot.items():
            say(f"{k}, {what} at batch {batch} ({n_sites} sites): call "
                f"{r[pre + 'ms']:.4f} ms (library {r[pre + 'library_ms']:.4f}), device "
                f"{r[pre + 'device_ms']:.4f} ms (library {r[pre + 'library_device_ms']:.4f}), "
                f"{r[pre + 'device_ms'] / n_sites * 1e3:.2f} us a site; bound "
                f"{r[pre + 'bound_ms']:.4f} ms")
    for M, C, P in BN_CHECK_SHAPES:
        _, e_f, e_b = bn_check(torch, fused_norm, gen, M, C, P, True)
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
    dms = graph_ms(lambda: fused_update.fused_sgd_cuda(graw, p_k, b_k, mask_flat, scal, **kw),
                   calls=10, samples=11)
    nbytes = 6 * 4 * n
    bound = max(nbytes / BW, 10 * n / F32) * 1e3
    say(f"  fused_sgd: kernel {ms:.4f} ms (device {dms:.4f})  plain {pms:.4f} ms  bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "device_ms": dms, "plain_ms": pms, "bound_ms": bound, "err": worst,
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
    dms = graph_ms(lambda: quant.quant_pack_cuda(x, s, u, qmax, bias), calls=10, samples=11)
    nbytes = 17 * n  # read x, s, u; write q and the words
    nops = 10 * n
    bound = max(nbytes / BW, nops / F32) * 1e3
    say(f"  quant_pack: kernel {ms:.4f} ms (device {dms:.4f})  plain {pms:.4f} ms  bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB)  library: no one PyTorch call")
    codec = codecs.Int8Codec(spec, 1)
    counts = torch.full((n,), 10.0, device=dev)
    resid = torch.zeros((1, n), device=dev)
    cms = time_ms(lambda: codecs.compressed_sum(codec, P, x, counts, resid, u, 10),
                  reps=2, samples=11)
    say(f"  int8 codec step of a round (compressed_sum, cohort of 10): {cms:.4f} ms")
    return {"ms": ms, "device_ms": dms, "plain_ms": pms, "bound_ms": bound, "err": worst,
            "bytes": nbytes, "ops": nops, "library_ms": None}


def small_round_phase(torch, wire_codec, norm="bn"):
    """One small round of the port on the card (kernels) against the same
    round on the CPU (plain versions): MNIST conv twin under ``norm``, epoch
    permutations (and the int8 codec's noise) injected so both sides see
    the same draws.
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
    cfg["control"] = C.parse_control_name(f"1_4_1_iid_fix_a1-b1-c1-e1_{norm}_1_1")
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
    what = f"small round ({wire_codec}, {norm}), card vs CPU"
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


def zero(counters) -> None:
    for counts in counters:
        for k in counts:
            counts[k] = 0


def read(counters):
    return {k: v for counts in counters for k, v in counts.items()}


def fed_argv(out_dir: str, codec: str, local_epochs: int, rounds: int, *extra):
    """The headline control's flags for the federated entries."""
    return ["--control_name", HEADLINE, "--synthetic", "1", "--synthetic_sizes", json.dumps(SIZES),
            "--pallas_norm", "1", "--fused_update", "1", "--wire_codec", codec,
            "--eval_interval", str(ROUNDS), "--output_dir", out_dir,
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": local_epochs}}),
            *extra]


def say_checkpoints(what: str, hist, unit: str = "round") -> None:
    """The seconds and megabytes of each round's (epoch's) checkpoint write
    (the host copy of the params included) and best copy, and their share
    of the round."""
    for r in hist:
        best = "no best copy" if r["best_seconds"] is None else \
            f"best copy {r['best_seconds']:.3f} s"
        say(f"  {what} {unit} {r['epoch']}: checkpoint {r['checkpoint_mb']:.1f} MB in "
            f"{r['checkpoint_seconds']:.3f} s ({r['checkpoint_mb'] / r['checkpoint_seconds']:.0f} "
            f"MB/s, {100 * r['checkpoint_seconds'] / r['seconds']:.2f}% of the {unit}'s "
            f"{r['seconds']:.2f} s), {best}")


def main_path(torch, counters, codec: str, local_epochs: int, out_dir: str, rounds: int,
              *extra):
    """``train_classifier_fed`` on the headline control up to round
    ``rounds`` with evaluation after the last, the launch counters set to 0
    just before and read just after -> (launches, result, seconds)."""
    from heterofl_tpu_torch.entry import train_classifier_fed

    argv = fed_argv(out_dir, codec, local_epochs, rounds, *extra)
    say(f"main path ({codec}): train_classifier_fed {' '.join(argv)}")
    zero(counters)
    t0 = time.time()
    (result,) = train_classifier_fed.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = read(counters)
    hist = result["history"]
    say(f"main path ({codec}): {secs:.1f} s for {len(hist)} round(s), local epochs "
        f"{local_epochs}; launches {launches}")
    for r in hist:
        say(f"  round {r['epoch']}: loss {r['loss']:.4f} accuracy {r['accuracy']:.2f}% "
            f"{r['seconds']:.2f} s ({r['n']:.0f} samples)")
    say_checkpoints(f"main path ({codec})", hist)
    last = hist[-1] if hist else {}
    names = ("Local-Loss", "Local-Accuracy", "Global-Loss", "Global-Accuracy", "eval_seconds")
    if not all(k in last for k in names):
        raise AssertionError(f"main path ({codec}): no evaluation after round {rounds}: {last}")
    say(f"  evaluation after round {last['epoch']}: Local loss {last['Local-Loss']:.4f} "
        f"accuracy {last['Local-Accuracy']:.2f}%, Global loss {last['Global-Loss']:.4f} "
        f"accuracy {last['Global-Accuracy']:.2f}%, {last['eval_seconds']:.2f} s "
        f"(sBN over the train set, then Local, then Global)")
    if hist[-1]["epoch"] != rounds or not all(math.isfinite(r["loss"]) for r in hist) \
            or not all(math.isfinite(last[k]) for k in names):
        raise AssertionError(f"main path ({codec}): expected finite round losses up to round "
                             f"{rounds} and finite test metrics, got {hist}")
    return launches, result, secs


def resume_path(torch, counters, codec: str, local_epochs: int, out_dir: str):
    """The same entry with one more round and ``--resume_mode 1``: it must
    train exactly round ``ROUNDS + 1``, from params (and, int8, the
    error-feedback residual) equal to the checkpoint's bit for bit, and its
    log must hold ``ROUNDS + 1`` train entries -> (launches, result)."""
    import numpy as np

    from heterofl_tpu_torch.convert import flat_to_jax, params_to_jax
    from heterofl_tpu_torch.entry import common
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint

    blob = load_checkpoint(checkpoint_path(out_dir, TAG))
    start = {}
    train_round = common.FedExperiment.train_round

    def first_round(self, P, epoch, lr):  # what the resumed run starts from
        if not start:
            start["params"] = params_to_jax(self.engine.unflatten(P), self.perms)
            resid = self.engine.wire_resid_host()
            start["resid"] = None if resid is None else \
                flat_to_jax(resid, self.engine.spec.shapes, self.perms)[None]
        return train_round(self, P, epoch, lr)

    common.FedExperiment.train_round = first_round
    try:
        launches, result, _ = main_path(torch, counters, codec, local_epochs, out_dir,
                                        ROUNDS + 1, "--resume_mode", "1")
    finally:
        common.FedExperiment.train_round = train_round
    what = f"resumed path ({codec})"
    epochs = [r["epoch"] for r in result["history"]]
    if blob["epoch"] != ROUNDS + 1 or epochs != [ROUNDS + 1]:
        raise AssertionError(f"{what}: checkpoint at epoch {blob['epoch']}, trained {epochs}; "
                             f"expected exactly round {ROUNDS + 1}")
    same = lambda a, b: a.shape == b.shape and np.array_equal(a.view(np.int32),  # noqa: E731
                                                               b.view(np.int32))
    if sorted(start["params"]) != sorted(blob["params"]) or not all(
            same(v, blob["params"][k]) for k, v in start["params"].items()):
        raise AssertionError(f"{what}: the params it started from differ from the checkpoint's")
    n_params = sum(v.size for v in start["params"].values())
    if codec == "dense":
        if blob["wire_resid"] is not None or start["resid"] is not None:
            raise AssertionError(f"{what}: a dense run carries no residual")
        resid = "no residual (dense)"
    else:
        if start["resid"] is None or not same(start["resid"], blob["wire_resid"]) \
                or not blob["wire_resid"].any():
            raise AssertionError(f"{what}: the residual it restored differs from the checkpoint's")
        resid = f"the residual {blob['wire_resid'].shape} equal bit for bit"
    n_train = len(result["logger"].history["train/Local-Loss"])
    if n_train != ROUNDS + 1:
        raise AssertionError(f"{what}: the log holds {n_train} train entries, expected "
                             f"{ROUNDS + 1}")
    say(f"{what}: trained round {ROUNDS + 1} only, from {n_params} params equal to the "
        f"checkpoint's bit for bit, {resid}; the log holds {n_train} train entries")
    return launches, result


def close_to_logged(what: str, loss: float, acc: float, logged_loss: float, logged_acc: float):
    d_loss, d_acc = abs(loss - logged_loss), abs(acc - logged_acc)
    say(f"{what}: loss {loss:.6f} (logged {logged_loss:.6f}, |diff| {d_loss:.3e}), accuracy "
        f"{acc:.4f}% (logged {logged_acc:.4f}%, |diff| {d_acc:.4f}); tolerance "
        f"{TOL_EVAL_LOSS:g} relative, {TOL_EVAL_ACC:g} points")
    if not (d_loss <= TOL_EVAL_LOSS * max(1.0, abs(logged_loss)) and d_acc <= TOL_EVAL_ACC):
        raise AssertionError(f"{what}: the evaluation does not reproduce the logged metrics")


def test_entry_phase(out_dir: str, codec: str, local_epochs: int) -> None:
    """``test_classifier_fed`` on the best checkpoint: its Global loss and
    accuracy against the values the training log holds for that round."""
    from heterofl_tpu_torch.entry import test_classifier_fed
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint

    best = load_checkpoint(checkpoint_path(out_dir, TAG, "best"))
    hist = best["logger_history"]
    (bundle,) = test_classifier_fed.main(fed_argv(out_dir, codec, local_epochs, ROUNDS + 1))
    got = bundle["logger_history"]
    close_to_logged(f"test_classifier_fed ({codec}) on the best checkpoint (round "
                    f"{best['epoch'] - 1})", got["test/Global-Loss"][0],
                    got["test/Global-Accuracy"][0], hist["test/Global-Loss"][-1],
                    hist["test/Global-Accuracy"][-1])


def central_phase(torch, counters, out_dir: str):
    """``train_classifier`` (the centralised baseline at batch 100 on the
    same synthetic CIFAR10, full-width ResNet-18, ``pallas_norm=1``) for
    ``CENTRAL_EPOCHS``, the launch counters set to 0 just before and read
    just after, then ``test_classifier`` on its best checkpoint ->
    launches."""
    from heterofl_tpu_torch.entry import test_classifier, train_classifier
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint

    argv = ["--control_name", CENTRAL, "--synthetic", "1", "--synthetic_sizes", json.dumps(SIZES),
            "--pallas_norm", "1", "--output_dir", out_dir,
            "--override", json.dumps({"num_epochs": CENTRAL_EPOCHS})]
    say(f"centralised path: train_classifier {' '.join(argv)}")
    zero(counters)
    t0 = time.time()
    (result,) = train_classifier.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = read(counters)
    steps = CENTRAL_EPOCHS * math.ceil(SIZES["train"] / CENTRAL_BATCH)
    say(f"centralised path: {secs:.1f} s for {CENTRAL_EPOCHS} epoch(s) of {steps // CENTRAL_EPOCHS} "
        f"steps at batch {CENTRAL_BATCH}; launches {launches}")
    hist = result["history"]
    for r in hist:
        say(f"  epoch {r['epoch']}: loss {r['loss']:.4f} accuracy {r['accuracy']:.2f}% "
            f"{r['seconds']:.2f} s ({1e3 * r['seconds'] / (steps // CENTRAL_EPOCHS):.2f} ms a "
            f"step); test loss {r['Loss']:.4f} accuracy {r['Accuracy']:.2f}% after sBN, "
            f"{r['eval_seconds']:.2f} s")
    say_checkpoints("centralised path", hist, "epoch")
    want = {"bn_fwd": BN_SITES * steps, "bn_bwd": BN_SITES * steps, "fused_sgd": 0,
            "quant_pack": 0, **NO_BATCHED}
    if launches != want:
        raise AssertionError(f"centralised path: launches {launches}, expected {want}")
    if len(hist) != CENTRAL_EPOCHS or not all(
            math.isfinite(r[k]) for r in hist for k in ("loss", "Loss", "Accuracy")):
        raise AssertionError(f"centralised path: expected finite losses, got {hist}")
    best = load_checkpoint(checkpoint_path(out_dir, CENTRAL_TAG, "best"))["logger_history"]
    (bundle,) = test_classifier.main(argv)
    close_to_logged("test_classifier on the centralised best checkpoint",
                    bundle["metrics"]["Loss"], bundle["metrics"]["Accuracy"],
                    best["test/Loss"][-1], best["test/Accuracy"][-1])
    return launches


# --- the sixth slice: files on disk, dynamic rates, group norms, ResNet-50 ---------

def r50_cfg(control: str = R50_CONTROL):
    """ResNet-50 at full width on CIFAR10, ``pallas_norm``, one local epoch."""
    from heterofl_tpu_torch import config as C

    cfg = C.default_cfg()
    cfg.update(control=C.parse_control_name(control), model_name="resnet50", pallas_norm=True)
    cfg["override"] = {"num_epochs": {"global": 1, "local": 1}}
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def r50_bn_shapes(torch):
    """The distinct ``(M, C, sites)`` of ResNet-50's BN sites at batch 10:
    the rows and channels each site hands the fused route, recorded from
    one forward at batch 1 on the CPU (M scales with the batch)."""
    from heterofl_tpu_torch.models import make_model, norms

    model = make_model(r50_cfg())
    seen = []
    fused = norms.batch_norm_fused

    def record(x, g, b, sample_weight=None):
        seen.append((BATCH * x.shape[2] * x.shape[3], x.shape[1]))
        return fused(x, g, b, sample_weight=sample_weight)

    norms.batch_norm_fused = record
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, 32, 32), torch.zeros(1, dtype=torch.int64))
    finally:
        norms.batch_norm_fused = fused
    if len(seen) != R50_SITES:
        raise AssertionError(f"ResNet-50 has {len(seen)} BN sites, not {R50_SITES}")
    shapes = [(M, C, seen.count((M, C))) for M, C in sorted(set(seen), key=lambda s: (-s[0], s[1]))]
    say(f"ResNet-50 BN sites at batch {BATCH}: {len(seen)} in {len(shapes)} shapes "
        f"(M, C, sites) {shapes}")
    return shapes


def resnet50_phase(torch, counters, card=None):
    """One ResNet-50 round at full width on the card (the BN and fused-SGD
    kernels) against the same round on the CPU (plain versions): a level-a
    and a level-e client of ``R50_SHARD`` samples each, epoch
    permutations and augmentation draws made on the CPU and injected;
    params within ``TOL_ROUND``.  The card round's launches must be 49 BN
    sites and one fused-SGD call a step.  Then the step time: a level-a
    client of ``R50_TIMED_STEPS`` steps, timed after a warm-up epoch ->
    (launches of the card round, ms a step)."""
    import numpy as np

    from heterofl_tpu_torch.data import synthetic_vision
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import RoundEngine

    card = card or torch.device("cuda")
    cfg = r50_cfg()
    ds = synthetic_vision("CIFAR10", "train", n=2 * R50_SHARD, seed=4)
    x = ds.data.reshape(2, R50_SHARD, 32, 32, 3)
    y = ds.target.reshape(2, R50_SHARD)
    sm = np.ones((2, R50_SHARD), np.float32)
    lm = np.ones((2, 10), np.float32)
    lm[1, ::4] = 0.0
    rng = np.random.default_rng(6)
    perms = {u: rng.permutation(R50_SHARD)[None] for u in range(2)}
    g = torch.Generator().manual_seed(7)
    steps = -(-R50_SHARD // BATCH)
    aug = {(u, t): (torch.randint(0, 9, (BATCH, 2), generator=g),
                    torch.rand(BATCH, generator=g) < 0.5) for u in range(2) for t in range(steps)}
    out = []
    for dev in (card, torch.device("cpu")):
        model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
        eng = RoundEngine(model, cfg, dev)
        data = tuple(torch.from_numpy(a).to(dev) for a in (x, y, sm, lm))
        P = eng.flatten(model.params())
        if eng.spec.total != R50_N:
            raise AssertionError(f"ResNet-50 has {eng.spec.total} params, not {R50_N}")
        zero(counters)
        new, ms = eng.train_round(P, 0.05, [0, 1], data, 0, epoch_perms=perms,
                                  aug_draws=lambda u, t: aug[u, t])
        launches = read(counters)
        out.append((new.cpu(), ms["loss_sum"].cpu(), launches))
    (c_new, c_loss, launches), (p_new, p_loss, _) = out
    d, dl = float((c_new - p_new).abs().max()), float((c_loss - p_loss).abs().max())
    say(f"ResNet-50 round at full width (levels a and e, {steps} steps each), card vs CPU: "
        f"max |params diff| {d:.3e}, max |loss_sum diff| {dl:.3e} (tolerance {TOL_ROUND:g}); "
        f"launches {launches}")
    want = {"bn_fwd": R50_SITES * 2 * steps, "bn_bwd": R50_SITES * 2 * steps,
            "fused_sgd": 2 * steps, "quant_pack": 0, **NO_BATCHED}
    if card.type == "cuda" and launches != want:
        raise AssertionError(f"ResNet-50 round: launches {launches}, expected {want}")
    if not (d <= TOL_ROUND and math.isfinite(dl) and dl <= 100 * TOL_ROUND):
        raise AssertionError("ResNet-50 round: the card disagrees with the CPU")
    # the step time of a level-a client on the card
    model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(card)
    eng = RoundEngine(model, cfg, card)
    n = R50_TIMED_STEPS * BATCH
    big = synthetic_vision("CIFAR10", "train", n=n, seed=5)
    xb, yb = torch.from_numpy(big.data).to(card), torch.from_numpy(big.target).to(card)
    smb = torch.ones(n, device=card)
    lmb = torch.ones(10, device=card)
    lr = torch.full((), 0.05, device=card)
    P = eng.flatten(model.params())
    times = []
    for rep_ in range(3):  # the first is the warm-up
        if card.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        zero(counters)
        _, acc = eng.local_train(P, 1.0, xb, yb, smb, lmb,
                                 torch.Generator(device=card).manual_seed(rep_), lr)
        float(acc[0])
        times.append((time.perf_counter() - t0) * 1e3 / R50_TIMED_STEPS)
    per_step = read(counters)
    say(f"ResNet-50 local step at full width, batch {BATCH}, level a: "
        f"{statistics.median(times[1:]):.2f} ms (epochs of {R50_TIMED_STEPS} steps: "
        f"{[round(t, 2) for t in times]} ms a step, the first the warm-up); port kernel "
        f"launches an epoch {per_step}")
    return launches, statistics.median(times[1:])


def write_cifar10_pickles(root: str, seed: int = 0):
    """CIFAR10 as the python-pickle batches under ``root/CIFAR10``:
    ``data_batch_1..5`` of ``CIFAR_BATCH_ROWS`` images and ``test_batch``,
    each ``{b'data': uint8 [n, 3072] (CHW rows), b'labels': [...]}``, the
    images class-conditional from a seed -> (train, test) as written."""
    import pickle

    import numpy as np

    from heterofl_tpu_torch.data import synthetic_vision

    base = os.path.join(root, "CIFAR10", "cifar-10-batches-py")
    os.makedirs(base)
    sets = {split: synthetic_vision("CIFAR10", split, n=SIZES[split], seed=seed)
            for split in ("train", "test")}
    files = [(f"data_batch_{i + 1}", "train", i * CIFAR_BATCH_ROWS, (i + 1) * CIFAR_BATCH_ROWS)
             for i in range(SIZES["train"] // CIFAR_BATCH_ROWS)]
    files.append(("test_batch", "test", 0, SIZES["test"]))
    for name, split, a, b in files:
        ds = sets[split]
        rows = np.ascontiguousarray(ds.data[a:b].transpose(0, 3, 1, 2).reshape(b - a, 3072))
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"batch_label": name.encode(), b"labels": ds.target[a:b].tolist(),
                         b"data": rows}, f, protocol=2)
    return sets["train"], sets["test"]


def write_emnist_idx(root: str, seed: int = 0):
    """EMNIST balanced as gzip IDX files under ``root/EMNIST/raw``, the
    images stored transposed (column-major, as EMNIST ships them) ->
    (train, test) as the reader must return them."""
    import gzip
    import struct

    import numpy as np

    from heterofl_tpu_torch.data import synthetic_vision

    base = os.path.join(root, "EMNIST", "raw")
    os.makedirs(base)
    out = []
    for split in ("train", "test"):
        ds = synthetic_vision("EMNIST", split, n=EMNIST_SIZES[split], seed=seed, subset="balanced")
        for kind, arr in (("images-idx3", ds.data[..., 0].transpose(0, 2, 1)),
                          ("labels-idx1", ds.target.astype(np.uint8))):
            head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
                ">" + "I" * arr.ndim, *arr.shape)
            with gzip.open(os.path.join(base, f"emnist-balanced-{split}-{kind}-ubyte.gz"), "wb",
                           compresslevel=1) as f:
                f.write(head + np.ascontiguousarray(arr, np.uint8).tobytes())
        out.append(ds)
    return out


def readers_phase(data_dir: str) -> None:
    """Phase a: CIFAR10 (pickle batches) and EMNIST balanced (gzip IDX)
    written into ``data_dir`` and read back through ``fetch_dataset``
    (``synthetic=False``): the images and labels equal what was written."""
    import numpy as np

    from heterofl_tpu_torch.data import fetch_dataset

    for name, write, kw in (("CIFAR10", write_cifar10_pickles, {}),
                            ("EMNIST", write_emnist_idx, {"subset": "balanced"})):
        t0 = time.time()
        written = write(data_dir)
        t_write = time.time() - t0
        t0 = time.time()
        got = fetch_dataset(name, data_dir=data_dir, synthetic=False, **kw)
        t_read = time.time() - t0
        for ds, split in zip(written, ("train", "test")):
            if not (np.array_equal(got[split].data, ds.data)
                    and np.array_equal(got[split].target, ds.target)
                    and got[split].classes_size == ds.classes_size):
                raise AssertionError(f"{name} {split}: the reader's arrays differ from the files'")
        mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                 os.walk(os.path.join(data_dir, name)) for f in fs) / 1e6
        say(f"readers: {name} {len(got['train'])} train and {len(got['test'])} test images, "
            f"{mb:.1f} MB of files written in {t_write:.2f} s, read back in {t_read:.2f} s, "
            f"equal to what was written")


def dynamic_path(torch, counters, data_dir: str, tmp: str, *extra):
    """Phase b: ``train_classifier_fed`` with the dynamic control on the
    CIFAR10 files (``--synthetic 0``), full-width ResNet-18, ``pallas_norm``
    and ``fused_update``, ``DYN_ROUNDS`` rounds of 1 local epoch, evaluated
    after the last.  Every drawn rate is a mode rate, the rounds draw
    different levels, every client's trained params are zero outside its
    width, the losses are finite and the BN and SGD launches are the steps
    times their sites.  Then round 2 again from the round-1 checkpoint
    (``--resume_mode 1``): from its params bit for bit, drawing the rates
    of the uninterrupted run's draw (both cohorts' rates are one population
    draw at round 2's seed) -> launches by path."""
    import shutil

    import numpy as np

    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.convert import params_to_jax
    from heterofl_tpu_torch.entry import common, train_classifier_fed
    from heterofl_tpu_torch.fed import round_rates
    from heterofl_tpu_torch.parallel import RoundEngine
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint
    from heterofl_tpu_torch.utils.checkpoint import generation_path

    out = os.path.join(tmp, "dynamic")

    def argv(out_dir, *more):
        return ["--control_name", DYNAMIC, "--data_dir", data_dir, "--synthetic", "0",
                "--pallas_norm", "1", "--fused_update", "1", "--eval_interval", str(DYN_ROUNDS),
                "--output_dir", out_dir, "--override",
                json.dumps({"num_epochs": {"global": DYN_ROUNDS, "local": 1}}), *more, *extra]

    local_train = RoundEngine.local_train
    suffix = []

    def checked(self, P, wr, *a, **k):  # each client's params outside its width
        p, acc = local_train(self, P, wr, *a, **k)
        suffix.append((wr, (p * (1.0 - self.param_mask_flat(wr))).abs().max()))
        return p, acc

    by_path = {}
    RoundEngine.local_train = checked
    try:
        say(f"dynamic path: train_classifier_fed {' '.join(argv(out))}")
        zero(counters)
        t0 = time.time()
        (result,) = train_classifier_fed.main(argv(out))
        by_path["dynamic"] = launches = read(counters)
    finally:
        RoundEngine.local_train = local_train
    hist = result["history"]
    steps = sum(len(r["users"]) for r in hist) * (SIZES["train"] // 100 // BATCH)
    say(f"dynamic path: {time.time() - t0:.1f} s for {len(hist)} rounds; launches {launches}")
    for r in hist:
        say(f"  round {r['epoch']}: users {r['users']} rates {r['user_rates']}; loss "
            f"{r['loss']:.4f} accuracy {r['accuracy']:.2f}% in {r['seconds']:.2f} s")
    say_checkpoints("dynamic path", hist)
    last = hist[-1]
    say(f"  evaluation after round {last['epoch']}: Local accuracy {last['Local-Accuracy']:.2f}%, "
        f"Global loss {last['Global-Loss']:.4f} accuracy {last['Global-Accuracy']:.2f}% in "
        f"{last['eval_seconds']:.2f} s")
    bad = [(wr, float(m)) for wr, m in suffix if float(m) != 0.0]
    say(f"  {len(suffix)} clients trained; params outside each client's width all zero: "
        f"{not bad}")
    want = {"bn_fwd": BN_SITES * steps, "bn_bwd": BN_SITES * steps, "fused_sgd": steps,
            "quant_pack": 0, **NO_BATCHED}
    drawn = [r["user_rates"] for r in hist]
    if not (len(hist) == DYN_ROUNDS and all(set(d) <= MODE_RATES for d in drawn)
            and drawn[0] != drawn[1] and not bad and len(suffix) == len(drawn) * 10
            and launches == want and all(math.isfinite(r["loss"]) for r in hist)
            and math.isfinite(last["Global-Loss"])):
        raise AssertionError(f"dynamic path: rates {drawn}, launches {launches} (expected "
                             f"{want}), suffixes {bad}, history {hist}")
    # round 2 again, from the round-1 checkpoint
    res_dir = os.path.join(tmp, "dynamic_resumed")
    live = checkpoint_path(out, DYN_TAG)
    os.makedirs(os.path.dirname(checkpoint_path(res_dir, DYN_TAG)))
    shutil.copy(generation_path(live, 1), checkpoint_path(res_dir, DYN_TAG))
    blob = load_checkpoint(checkpoint_path(res_dir, DYN_TAG))
    start = {}
    train_round = common.FedExperiment.train_round

    def first_round(self, P, epoch, lr):
        start.setdefault("params", params_to_jax(self.engine.unflatten(P), self.perms))
        return train_round(self, P, epoch, lr)

    common.FedExperiment.train_round = first_round
    try:
        zero(counters)
        (res,) = train_classifier_fed.main(argv(res_dir, "--resume_mode", "1"))
        by_path["dynamic_resumed"] = launches = read(counters)
    finally:
        common.FedExperiment.train_round = train_round
    (rec,) = res["history"]
    cfg = C.process_control(dict(C.default_cfg(), control=C.parse_control_name(DYNAMIC)))
    pop = round_rates(common.round_seed(0, DYN_ROUNDS), cfg)
    same = sorted(start["params"]) == sorted(blob["params"]) and all(
        np.array_equal(v.view(np.int32), blob["params"][k].view(np.int32))
        for k, v in start["params"].items())
    say(f"dynamic resumed round: trained round {rec['epoch']} from the round-1 checkpoint "
        f"(params equal bit for bit: {same}); users {rec['users']} rates {rec['user_rates']}; "
        f"the uninterrupted round {DYN_ROUNDS}'s users {hist[-1]['users']} rates "
        f"{hist[-1]['user_rates']}; both the population draw at its seed: "
        f"{rec['user_rates'] == pop[rec['users']].tolist()} / "
        f"{hist[-1]['user_rates'] == pop[hist[-1]['users']].tolist()}; launches {launches}")
    if not (blob["epoch"] == DYN_ROUNDS and rec["epoch"] == DYN_ROUNDS and same
            and rec["user_rates"] == pop[rec["users"]].tolist()
            and hist[-1]["user_rates"] == pop[hist[-1]["users"]].tolist()
            and launches["bn_fwd"] == BN_SITES * launches["fused_sgd"] > 0
            and math.isfinite(rec["loss"])):
        raise AssertionError("dynamic resumed round: it does not resume the run it came from")
    return by_path


def emnist_path(torch, counters, data_dir: str, tmp: str, *extra):
    """Phase c: ``train_classifier_fed`` on the EMNIST files, the conv net at
    full width under ``gn``, 1 round of 1 local epoch: its normalisation
    statistics are computed from the train split and cached in
    ``data_dir/stats/EMNIST.npz``, the checkpoint's cfg holds them, no BN
    kernel runs and the fused-SGD kernel runs once a step.  Then the
    statistics computed again (equal to the cache bit for bit) and read
    from the cache, each timed -> launches."""
    import numpy as np

    from heterofl_tpu_torch.data import fetch_dataset
    from heterofl_tpu_torch.data import stats as S
    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint

    out = os.path.join(tmp, "emnist")
    argv = ["--control_name", EMNIST_CONTROL, "--data_name", "EMNIST", "--model_name", "conv",
            "--data_dir", data_dir, "--synthetic", "0", "--pallas_norm", "1",
            "--fused_update", "1", "--output_dir", out, "--override",
            json.dumps({"num_epochs": {"global": 1, "local": 1}}), *extra]
    cache = S.stats_path("EMNIST", data_dir)
    if os.path.exists(cache):
        raise AssertionError(f"{cache} exists before the run")
    say(f"EMNIST path: train_classifier_fed {' '.join(argv)}")
    zero(counters)
    t0 = time.time()
    (result,) = train_classifier_fed.main(argv)
    launches = read(counters)
    (r,) = result["history"]
    steps = len(r["users"]) * (EMNIST_SIZES["train"] // 100 // BATCH)
    say(f"EMNIST path: {time.time() - t0:.1f} s; launches {launches}; round loss "
        f"{r['loss']:.4f} accuracy {r['accuracy']:.2f}% in {r['seconds']:.2f} s; Global "
        f"accuracy {r['Global-Accuracy']:.2f}% in {r['eval_seconds']:.2f} s")
    blob = load_checkpoint(checkpoint_path(out, EMNIST_TAG))
    z = np.load(cache)
    stats = blob["cfg"].get("norm_stats")
    want = {"bn_fwd": 0, "bn_bwd": 0, "fused_sgd": steps, "quant_pack": 0, **NO_BATCHED}
    if not (stats is not None and np.array_equal(np.float32(stats[0]), z["mean"])
            and np.array_equal(np.float32(stats[1]), z["std"]) and launches == want
            and math.isfinite(r["loss"]) and math.isfinite(r["Global-Loss"])):
        raise AssertionError(f"EMNIST path: stats {stats} vs cache {dict(z)}, launches "
                             f"{launches} (expected {want})")
    train = fetch_dataset("EMNIST", data_dir=data_dir, synthetic=False)["train"].data
    t0 = time.time()
    mean, std = S.compute_stats(train)
    t_compute = time.time() - t0
    t0 = time.time()
    S.dataset_stats("EMNIST", train, data_dir)
    t_read = time.time() - t0
    if not (np.array_equal(mean, z["mean"]) and np.array_equal(std, z["std"])):
        raise AssertionError("EMNIST statistics computed again differ from the cache")
    say(f"EMNIST statistics over {len(train)} images: mean {mean.tolist()} std {std.tolist()}; "
        f"computed in {t_compute:.3f} s, read from the cache in {t_read * 1e3:.2f} ms")
    return launches, t_compute, t_read


# --- the masked LM -----------------------------------------------------------------

def lm_cfg(control: str = LM_CONTROL):
    """The LM control's processed cfg with the synthetic vocabulary's 512
    tokens (what ``process_dataset`` sets from the data)."""
    from heterofl_tpu_torch import config as C

    cfg = C.default_cfg()
    cfg.update(control=C.parse_control_name(control), data_name="WikiText2",
               model_name="transformer")
    cfg = C.process_control(cfg)
    cfg["num_tokens"] = cfg["classes_size"] = 512
    return cfg


def lm_round_phase(torch):
    """One LM round at full width on the card (the fused-SGD kernel)
    against the same round on the CPU (its plain version), for a level-a
    and a level-e client (one round each, on the first ``tokens`` of the
    client's row), with the corruption and dropout draws made on the CPU
    and injected; params within ``TOL_LM_ROUND``, the ``<mask>`` row
    unchanged on both.  The level-e client trains 2 windows, not 10: at
    1/16 width its Scaler multiplies q and k by 16, the attention
    saturates, and a one-ulp change of the params grows about 30x a step
    (5.6e-7, 3.0e-5, 9.2e-4 after 1-3 steps on the CPU), so over 10 steps
    no tolerance tells float rounding from a fault."""
    import numpy as np

    from heterofl_tpu_torch.data import batchify, fetch_dataset
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import RoundEngine

    cfg = lm_cfg()
    t = cfg["transformer"]
    E, F, L = t["embedding_size"], t["hidden_size"], t["num_layers"]
    tok = fetch_dataset("WikiText2", synthetic=True, synthetic_sizes=LM_SIZES)["train"].token
    rows = batchify(tok, 100)[:, None, :]  # [users, 1 row, tokens]
    lm = np.ones((100, cfg["num_tokens"]), np.float32)
    lm[99, ::3] = 0.0  # the level-e client misses a third of the vocabulary

    def draws(uid, step):
        g = torch.Generator().manual_seed(1000 * uid + step)
        keep = {site: torch.rand((1, cfg["bptt"], F if site % 3 == 2 else E), generator=g)
                < 1.0 - t["dropout"] for site in range(1 + 3 * L)}
        return {"corrupt": torch.rand((1, cfg["bptt"]), generator=g) < cfg["mask_rate"],
                "keep": keep}

    for uid, tokens in LM_ROUND_CLIENTS:
        out = []
        for dev in (torch.device("cuda"), torch.device("cpu")):
            model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
            eng = RoundEngine(model, cfg, dev)
            P = eng.flatten(model.params())
            data = (torch.from_numpy(rows[:, :, :tokens]).to(dev), torch.from_numpy(lm).to(dev))
            new, ms = eng.train_round(P, cfg["lr"], [uid], data, 0, lm_draws=draws)
            tok_w = eng.spec.leaf(new, "embedding.tok.w")
            if not torch.equal(tok_w[-1], eng.spec.leaf(P, "embedding.tok.w")[-1]):
                raise AssertionError(f"LM round on {dev}: the <mask> embedding row moved")
            out.append((new.cpu(), ms["loss_sum"].cpu(), ms["n"].cpu()))
        (card, l_card, n_card), (cpu, l_cpu, n_cpu) = out
        d, dl = float((card - cpu).abs().max()), float((l_card - l_cpu).abs().max())
        say(f"LM round at full width, user {uid} (width {eng.fix_rates[uid]:g}, "
            f"{tokens // cfg['bptt']} steps), card vs CPU: max |params diff| {d:.3e}, max "
            f"|loss_sum diff| {dl:.3e} (tolerance {TOL_LM_ROUND:g}); n {n_card.tolist()}")
        if not (d <= TOL_LM_ROUND and dl <= 100 * TOL_LM_ROUND
                and torch.equal(n_card, n_cpu)):
            raise AssertionError(f"LM round, user {uid}: the card disagrees with the CPU")


def lm_argv(out_dir: str, rounds: int, *extra, control: str = LM_CONTROL):
    """Flags of the LM entries at full width on synthetic WikiText2."""
    epochs = rounds if control == CENTRAL else {"global": rounds, "local": 1}
    return ["--control_name", control, "--synthetic", "1", "--synthetic_sizes",
            json.dumps(LM_SIZES), "--fused_update", "1", "--eval_interval", "1",
            "--output_dir", out_dir, "--override", json.dumps({"num_epochs": epochs}), *extra]


def mask_row_kept(torch, params) -> None:
    """The ``<mask>`` row of the token embedding still holds its initial
    value (the experiment's model starts from seed 0)."""
    from heterofl_tpu_torch.models import make_model

    init = make_model(lm_cfg()).init_(torch.Generator().manual_seed(0))
    row = params["embedding.tok.w"][-1].detach().cpu()
    if not torch.equal(row, init.params()["embedding.tok.w"][-1].detach()):
        raise AssertionError("the <mask> embedding row moved off its initial value")


def lm_path(torch, counters, what: str, out_dir: str, rounds: int, *extra):
    """``train_transformer_fed`` up to round ``rounds``, the launch
    counters set to 0 just before and read just after -> (launches,
    result).  Every round trains ``LM_STEPS`` steps (one fused-SGD call, a
    kernel pair, each), launches no batch-norm kernel and keeps the
    ``<mask>`` row; the params come out finite at their shapes."""
    from heterofl_tpu_torch.entry import train_transformer_fed

    argv = lm_argv(out_dir, rounds, *extra)
    say(f"{what}: train_transformer_fed {' '.join(argv)}")
    zero(counters)
    t0 = time.time()
    (result,) = train_transformer_fed.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = read(counters)
    hist = result["history"]
    say(f"{what}: {secs:.1f} s for {len(hist)} round(s); launches {launches} "
        f"({2 * launches['fused_sgd']} fused-SGD kernel launches, two a step)")
    for r in hist:
        say(f"  round {r['epoch']}: loss {r['loss']:.4f} perplexity {r['perplexity']:.2f} "
            f"{r['seconds']:.2f} s ({1e3 * r['seconds'] / LM_STEPS:.2f} ms a step, "
            f"{r['n']:.0f} rows); Global loss {r.get('Global-Loss', float('nan')):.4f} "
            f"perplexity {r.get('Global-Perplexity', float('nan')):.2f} in "
            f"{r.get('eval_seconds', float('nan')):.2f} s")
    say_checkpoints(what, hist)
    want = {"bn_fwd": 0, "bn_bwd": 0, "fused_sgd": LM_STEPS * len(hist),
            "quant_pack": len(hist) if "int8" in argv else 0, **NO_BATCHED}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{what}: launches {launches}, expected {want} and the rest")
    if not hist or not all(math.isfinite(r[k]) for r in hist
                           for k in ("loss", "perplexity", "Global-Perplexity")):
        raise AssertionError(f"{what}: expected finite losses and Global-Perplexity, got {hist}")
    model_shapes = {k: tuple(v.shape) for k, v in result["params"].items()}
    if sum(math.prod(s) for s in model_shapes.values()) != LM_N or not all(
            bool(torch.isfinite(v).all()) for v in result["params"].values()):
        raise AssertionError(f"{what}: the params are not finite at the model's {LM_N} entries")
    mask_row_kept(torch, result["params"])
    return launches, result


def lm_phases(torch, counters, tmp: str, phases) -> dict:
    """The LM main path, its resumed round, ``test_transformer_fed``, an
    int8 round and the centralised LM -> launches by path."""
    import numpy as np

    from heterofl_tpu_torch.convert import params_to_jax
    from heterofl_tpu_torch.entry import common, test_transformer, test_transformer_fed
    from heterofl_tpu_torch.entry import train_transformer
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint

    by_path = {}
    lm_dir = os.path.join(tmp, "lm")
    by_path["lm"], _ = lm_path(torch, counters, "LM main path", lm_dir, LM_ROUNDS)
    phases.done("LM main path")
    blob = load_checkpoint(checkpoint_path(lm_dir, LM_TAG))
    start = {}
    train_round = common.FedExperiment.train_round

    def first_round(self, P, epoch, lr):
        start.setdefault("params", params_to_jax(self.engine.unflatten(P), self.perms))
        return train_round(self, P, epoch, lr)

    common.FedExperiment.train_round = first_round
    try:
        by_path["lm_resumed"], result = lm_path(torch, counters, "LM resumed path", lm_dir,
                                                LM_ROUNDS + 1, "--resume_mode", "1")
    finally:
        common.FedExperiment.train_round = train_round
    epochs = [r["epoch"] for r in result["history"]]
    same = all(np.array_equal(v.view(np.int32), blob["params"][k].view(np.int32))
               for k, v in start["params"].items())
    if blob["epoch"] != LM_ROUNDS + 1 or epochs != [LM_ROUNDS + 1] or not same \
            or sorted(start["params"]) != sorted(blob["params"]):
        raise AssertionError(f"LM resumed path: trained {epochs} from params equal to the "
                             f"checkpoint's: {same}")
    say(f"LM resumed path: trained round {LM_ROUNDS + 1} only, from params equal to the "
        f"checkpoint's bit for bit")
    phases.done("LM resumed round")
    best = load_checkpoint(checkpoint_path(lm_dir, LM_TAG, "best"))
    (bundle,) = test_transformer_fed.main(lm_argv(lm_dir, LM_ROUNDS + 1))
    got = bundle["logger_history"]["test/Global-Perplexity"][0]
    logged = best["logger_history"]["test/Global-Perplexity"][-1]
    say(f"test_transformer_fed on the best checkpoint (round {best['epoch'] - 1}): "
        f"Global-Perplexity {got:.6f} (logged {logged:.6f}, relative |diff| "
        f"{abs(got / logged - 1):.3e}; tolerance {TOL_EVAL_LOSS:g})")
    if not abs(got - logged) <= TOL_EVAL_LOSS * abs(logged):
        raise AssertionError("test_transformer_fed does not reproduce the logged perplexity")
    phases.done("test_transformer_fed")
    by_path["lm_int8"], result = lm_path(torch, counters, "LM int8 path",
                                         os.path.join(tmp, "lm_int8"), 1, "--wire_codec", "int8")
    if by_path["lm_int8"]["quant_pack"] != 1 or not np.any(result["wire_resid"]):
        raise AssertionError(f"LM int8 round: launches {by_path['lm_int8']}, a residual is due")
    phases.done("LM int8 round")
    out = os.path.join(tmp, "lm_central")
    argv = lm_argv(out, 1, control=CENTRAL)
    say(f"centralised LM: train_transformer {' '.join(argv)}")
    zero(counters)
    t0 = time.time()
    (result,) = train_transformer.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    by_path["lm_central"] = launches = read(counters)
    (r,) = result["history"]
    say(f"centralised LM: {secs:.1f} s for one epoch of {LM_STEPS} steps of [100, 64]; "
        f"launches {launches}; loss {r['loss']:.4f} perplexity {r['perplexity']:.2f} in "
        f"{r['seconds']:.2f} s ({1e3 * r['seconds'] / LM_STEPS:.2f} ms a step); test "
        f"perplexity {r['Perplexity']:.2f} in {r['eval_seconds']:.2f} s")
    say_checkpoints("centralised LM", result["history"], "epoch")
    if any(launches.values()) or not all(math.isfinite(r[k]) for k in
                                         ("loss", "perplexity", "Perplexity")):
        raise AssertionError(f"centralised LM: launches {launches} (none due), {r}")
    best = load_checkpoint(checkpoint_path(out, LM_CENTRAL_TAG, "best"))["logger_history"]
    (bundle,) = test_transformer.main(argv)
    got, logged = bundle["metrics"]["Perplexity"], best["test/Perplexity"][-1]
    say(f"test_transformer on the centralised best checkpoint: Perplexity {got:.6f} (logged "
        f"{logged:.6f})")
    if not abs(got - logged) <= TOL_EVAL_LOSS * abs(logged):
        raise AssertionError("test_transformer does not reproduce the logged perplexity")
    phases.done("centralised LM and test_transformer")
    return by_path


# -- the grouped engine (seventh slice) ---------------------------------------


def level_width(C: int, rate: float) -> int:
    return int(math.ceil(C * rate))


def bn_batched_check(torch, fused_norm, gen, M: int, C: int, P: int, G: int):
    """Both batched batch-norm kernels (1b/2b) at ``x2 [M, G*C]`` against
    their plain versions (``TOL_BN``) and against a second call (equal
    bits).  The last client has a zero-weight (padding) sample whose row
    holds a NaN in that client's columns, which must stay out of its
    statistics -> (inputs, max errors)."""
    dev = torch.device("cuda")
    B = M // P
    GC = G * C
    x2 = torch.randn(M, GC, device=dev, generator=gen)
    w = torch.ones(G, B, device=dev)
    w[G - 1, B - 1] = 0.0
    g = torch.randn(GC, device=dev, generator=gen)
    b = torch.randn(GC, device=dev, generator=gen)
    dy = torch.randn(M, GC, device=dev, generator=gen)
    xf = x2.clone()
    xf[(B - 1) * P, (G - 1) * C:] = float("nan")
    y_k, st_k = fused_norm.bn_fwd_batched_cuda(xf, w, P, g, b)
    y_p, st_p = fused_norm.bn_fwd_batched_plain(xf, w, P, g, b)
    what = f"G={G} M={M} C={C}"
    e_f = max(check_close(f"bn_fwd_batched y {what}", y_k, y_p, *TOL_BN["y"]),
              check_close(f"bn_fwd_batched stats {what}", st_k, st_p, *TOL_BN["y"]))
    if not bool(torch.isfinite(st_k).all()):
        raise AssertionError(f"bn_fwd_batched {what}: non-finite statistics")
    y_2, st_2 = fused_norm.bn_fwd_batched_cuda(xf, w, P, g, b)
    st_p = fused_norm.bn_fwd_batched_plain(x2, w, P, g, b)[1]
    dx_k, dg_k, db_k = fused_norm.bn_bwd_batched_cuda(x2, w, P, g, dy, st_p)
    dx_p, dg_p, db_p = fused_norm.bn_bwd_batched_plain(x2, w, P, g, dy, st_p)
    e_b = max(check_close(f"bn_bwd_batched dx {what}", dx_k, dx_p, *TOL_BN["dx"]),
              check_close(f"bn_bwd_batched dg {what}", dg_k, dg_p, *TOL_BN["dg"]),
              check_close(f"bn_bwd_batched db {what}", db_k, db_p, *TOL_BN["db"]))
    again = fused_norm.bn_bwd_batched_cuda(x2, w, P, g, dy, st_p)
    torch.cuda.synchronize()
    if not all(same_bits(torch, a, c) for a, c in zip((y_k, st_k, dx_k, dg_k, db_k),
                                                         (y_2, st_2) + again)):
        raise AssertionError(f"batched BN {what}: two calls on the same inputs differ")
    return (x2, w, g, b, dy, st_p), e_f, e_b


def bn_batched_phase(torch, fused_norm):
    """Kernels 1b/2b held at ResNet-18's site shapes at batch 10 for every
    level (C from 64 r to 512 r) and G in ``GROUPED_G`` -- at level e a
    channel tile of the plan holds several clients -- and timed over a
    step's 17 sites for ``GROUPED_TIMED`` -> per kernel, the totals of the
    first timed (G, level) and ``by_level`` for each."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(7)
    tot = {k: {"err": 0.0, "by_level": []} for k in ("bn_fwd_batched", "bn_bwd_batched")}
    straddle = 0
    for rate in LEVELS:
        for G in GROUPED_G:
            for M, C0, _ in BN_SHAPES:
                C = level_width(C0, rate)
                pl = fused_norm.bn_plan(M, G * C, True)
                straddle += int(G > 1 and (pl.tile_c > C or C % pl.tile_c != 0))
                _, e_f, e_b = bn_batched_check(torch, fused_norm, gen, M, C, M // BATCH, G)
                tot["bn_fwd_batched"]["err"] = max(tot["bn_fwd_batched"]["err"], e_f)
                tot["bn_bwd_batched"]["err"] = max(tot["bn_bwd_batched"]["err"], e_b)
    say(f"batched BN held at {len(LEVELS) * len(GROUPED_G) * len(BN_SHAPES)} (level, G, site) "
        f"shapes, {straddle} of them with channel tiles holding more than one client; bit-"
        f"identical across two calls")
    for G, rate in GROUPED_TIMED:
        t_all = {k: dict.fromkeys(("ms", "plain_ms", "device_ms", "bound_ms", "bytes", "ops"),
                                  0.0) for k in tot}
        for M, C0, sites in BN_SHAPES:
            C = level_width(C0, rate)
            P = M // BATCH
            (x2, w, g, b, dy, st), _, _ = bn_batched_check(torch, fused_norm, gen, M, C, P, G)
            GC = G * C
            calls = {"bn_fwd_batched": (lambda: fused_norm.bn_fwd_batched_cuda(x2, w, P, g, b),
                                        lambda: fused_norm.bn_fwd_batched_plain(x2, w, P, g, b)),
                     "bn_bwd_batched": (lambda: fused_norm.bn_bwd_batched_cuda(x2, w, P, g, dy, st),
                                        lambda: fused_norm.bn_bwd_batched_plain(x2, w, P, g, dy,
                                                                                st))}
            nbytes = {"bn_fwd_batched": 4 * (2 * M * GC + G * BATCH + 2 * GC + 3 * GC),
                      "bn_bwd_batched": 4 * (3 * M * GC + G * BATCH + GC + 3 * GC + 2 * GC)}
            nops = {"bn_fwd_batched": 9 * M * GC, "bn_bwd_batched": 14 * M * GC}
            for k, (kern, plain) in calls.items():
                t = {"ms": time_ms(kern, samples=9), "plain_ms": time_ms(plain, samples=9),
                     "device_ms": graph_ms(kern, samples=9),
                     "bound_ms": max(nbytes[k] / BW, nops[k] / F32) * 1e3}
                for key in ("ms", "plain_ms", "device_ms", "bound_ms"):
                    t_all[k][key] += sites * t[key]
                t_all[k]["bytes"] += sites * nbytes[k]
                t_all[k]["ops"] += sites * nops[k]
        for k, r in t_all.items():
            say(f"{k}, a training step of G={G} clients at level {rate:g} (17 sites): call "
                f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms; library: none (no PyTorch call takes a weight "
                f"per client and sample)")
            tot[k]["by_level"].append({"G": G, "rate": rate, **r})
    for k in tot:
        tot[k].update(tot[k]["by_level"][0])
    return tot


def sgd_batched_phase(torch, fused_update, n_by_rate):
    """Kernel 3b at ``[G, n_l]`` for levels a (G 2) and e (G 4): against its
    plain version (the clipped rows within ``TOL_SGD_CLIP``, the rest
    equal), against G launches of the one-client kernel on each row (equal
    bits), and against a second call (equal bits); row 0 clips, row 1 has
    ``has`` 0.  Timed at level a -> results, ``by_level``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    kw = dict(momentum=0.9, weight_decay=5e-4, max_norm=1.0)
    out = {"err": 0.0, "by_level": []}
    for rate, G in ((1.0, 2), (0.0625, 4)):
        n = n_by_rate[rate]
        mask = (torch.rand(n, device=dev, generator=gen) < 0.9).to(torch.float32)
        p0 = torch.randn(G, n, device=dev, generator=gen)
        b0 = torch.randn(G, n, device=dev, generator=gen) * 0.1
        g = torch.randn(G, n, device=dev, generator=gen)
        clip = [i % 3 == 0 for i in range(G)]  # rows 0 and 3 clip, the rest not
        g[[i for i in range(G) if not clip[i]]] *= 1e-5
        scal = torch.tensor([[7.0, 0.1, 0.0 if i == 1 else 1.0] for i in range(G)], device=dev)
        p_k, b_k = p0.clone(), b0.clone()
        fused_update.fused_sgd_batched_cuda(g, p_k, b_k, mask, scal, **kw)
        p_2, b_2 = p0.clone(), b0.clone()
        fused_update.fused_sgd_batched_cuda(g, p_2, b_2, mask, scal, **kw)
        p_r, b_r = fused_update.fused_sgd_batched_plain(g, p0, b0, mask, scal, **kw)
        bitwise = same_bits(torch, p_k, p_2) and same_bits(torch, b_k, b_2)
        for i in range(G):
            pu, bu = p0[i].clone(), b0[i].clone()
            fused_update.fused_sgd_cuda(g[i].clone(), pu, bu, mask, scal[i].clone(),
                                        **kw)
            bitwise = bitwise and same_bits(torch, pu, p_k[i]) and same_bits(torch, bu, b_k[i])
            tol = TOL_SGD_CLIP if clip[i] and scal[i, 2] > 0 else (0.0, 0.0)
            what = f"n={n} G={G} row {i} (clip={'on' if clip[i] else 'off'}, has=" \
                   f"{int(scal[i, 2])})"
            out["err"] = max(out["err"],
                             check_close(f"fused_sgd_batched p {what}", p_k[i], p_r[i], *tol),
                             check_close(f"fused_sgd_batched buf {what}", b_k[i], b_r[i], *tol))
        torch.cuda.synchronize()
        if not bitwise:
            raise AssertionError(f"fused_sgd_batched n={n} G={G}: a row differs from the "
                                 f"one-client kernel on it, or two calls differ")
        say(f"fused_sgd_batched n={n} G={G}: every row bit for bit the one-client kernel's, "
            f"two calls equal")
        p_t, b_t = p0.clone(), b0.clone()
        scal1 = scal.clone()
        scal1[:, 2] = 1.0
        ms = time_ms(lambda: fused_update.fused_sgd_batched_cuda(g, p_t, b_t, mask, scal1, **kw),
                     reps=5, samples=15)
        pms = time_ms(lambda: fused_update.fused_sgd_batched_plain(g, p0, b0, mask, scal1, **kw),
                      reps=2, samples=9)
        dms = graph_ms(lambda: fused_update.fused_sgd_batched_cuda(g, p_t, b_t, mask, scal1,
                                                                   **kw), calls=10, samples=11)
        nbytes = 4 * ((5 * G + 1) * n + 3 * G)  # read g, p, buf, mask, scal; write p, buf
        bound = max(nbytes / BW, 10 * G * n / F32) * 1e3
        say(f"  fused_sgd_batched n={n} G={G}: kernel {ms:.4f} ms (device {dms:.4f}), plain "
            f"{pms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); library: none")
        out["by_level"].append({"G": G, "rate": rate, "n": n, "ms": ms, "device_ms": dms,
                                "plain_ms": pms, "bound_ms": bound, "bytes": nbytes,
                                "ops": 10 * G * n})
        del p0, b0, g, p_k, b_k, p_2, b_2, p_r, b_r, p_t, b_t
        torch.cuda.empty_cache()
    out.update({k: v for k, v in out["by_level"][0].items() if k not in ("G", "rate", "n")})
    return out


def grouped_small_round_phase(torch, model_name: str):
    """One small round of the grouped engine on the card (the batched
    kernels) against the same round on the CPU (plain versions) within
    ``TOL_ROUND``, and on the card against the sliced twin (the one-client
    kernels) and the masked engine within ``TOL_GROUPED``: levels a (two
    clients), b, c and e, draws injected.  The conv net (16/32, MNIST, 2
    local epochs) and ResNet-18 (8/16/16/16, CIFAR10 with augmentation, 2
    steps a client: level e is chaotic over more)."""
    import numpy as np

    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.data import (fetch_dataset, label_split_masks, split_dataset,
                                         stack_client_shards)
    from heterofl_tpu_torch.fed.sliced import SlicedFederation
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
    from heterofl_tpu_torch.testing import assert_close

    conv = model_name == "conv"
    data_name = "MNIST" if conv else "CIFAR10"
    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name("1_5_1_iid_fix_a2-b1-c1-e1_bn_1_1")
    cfg["data_name"], cfg["model_name"], cfg["pallas_norm"] = data_name, model_name, True
    cfg["override"] = {"num_epochs": {"local": 2 if conv else 1},
                       "conv": {"hidden_size": [16, 32]},
                       "resnet": {"hidden_size": [8, 16, 16, 16]}}
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    U = 5
    ds = fetch_dataset(data_name, synthetic=True,
                       synthetic_sizes={"train": 500 if conv else 100, "test": 40})
    split, lsplit = split_dataset(ds, U, "iid", np.random.default_rng(0), classes_size=10)
    arrays = stack_client_shards(ds["train"].data, ds["train"].target, split["train"],
                                 list(range(U))) + (label_split_masks(lsplit, U, 10),)
    N, E, B = arrays[0].shape[1], cfg["num_epochs"]["local"], cfg["batch_size"]["train"]
    rng = np.random.default_rng(2)
    perms = {u: np.stack([rng.permutation(N) for _ in range(E)]) for u in range(U)}
    aug = {(u, t): (rng.integers(0, 9, (B, 2)), rng.random(B) < 0.5)
           for u in range(U) for t in range(E * math.ceil(N / B))}
    hooks = {"epoch_perms": perms}
    if not conv:
        hooks["aug_draws"] = lambda u, t: aug[u, t]
    users = list(range(U))
    out = {}
    for name, engine, dev in (("grouped card", GroupedRoundEngine, "cuda"),
                              ("grouped CPU", GroupedRoundEngine, "cpu"),
                              ("sliced card", SlicedFederation, "cuda"),
                              ("masked card", RoundEngine, "cuda")):
        dev = torch.device(dev)
        model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
        eng = engine(model, cfg, dev)
        data = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        new, ms = eng.train_round(eng.flatten(model.params()), 0.05, users, data, 0, **hooks)
        out[name] = (new.cpu(), ms["loss_sum"].cpu(), ms["n"].cpu())
    card = out["grouped card"]
    d = float((card[0] - out["grouped CPU"][0]).abs().max())
    dl = float((card[1] - out["grouped CPU"][1]).abs().max())
    say(f"grouped small round ({model_name}), card vs CPU: max |params diff| {d:.3e}, max "
        f"|loss_sum diff| {dl:.3e} (tolerance {TOL_ROUND:g})")
    if not (d <= TOL_ROUND and dl <= 100 * TOL_ROUND
            and torch.equal(card[2], out["grouped CPU"][2])):
        raise AssertionError(f"grouped small round ({model_name}): the card disagrees with the "
                             f"CPU")
    for other in ("sliced card", "masked card"):
        assert_close(f"grouped small round ({model_name}) vs {other}: params", card[0],
                     out[other][0], rtol=TOL_GROUPED[0], atol=TOL_GROUPED[1])
        if not torch.equal(card[2], out[other][2]):
            raise AssertionError(f"grouped small round ({model_name}): n differs from {other}")


def grouped_lm_round_phase(torch) -> None:
    """The grouped engine's LM round at full width with two clients at one
    level (``GROUPED_LM_USERS``, level b, ``GROUPED_LM_TOKENS`` tokens of
    their rows): on the card (the batched fused SGD, the batched
    transformer's per-client products, gathers and dropout) against the
    same round on the CPU within ``TOL_LM_ROUND``, the corruption and
    dropout draws made on the CPU at the level's widths and injected; then,
    at dropout 0, against the masked engine on the card within
    ``TOL_GROUPED`` (the only draws left are the corruption's, whose shape
    has no width, so both engines draw the same from the clients'
    generators)."""
    import numpy as np

    from heterofl_tpu_torch.data import batchify, fetch_dataset
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
    from heterofl_tpu_torch.testing import assert_close

    cfg = lm_cfg()
    t = cfg["transformer"]
    no_dropout = dict(cfg, transformer=dict(t, dropout=0.0))
    rate = float(cfg["model_rate"][GROUPED_LM_USERS[0]])
    if {float(cfg["model_rate"][u]) for u in GROUPED_LM_USERS} != {0.5}:
        raise AssertionError(f"grouped LM round: users {GROUPED_LM_USERS} are not at level b")
    E, F = level_width(t["embedding_size"], rate), level_width(t["hidden_size"], rate)
    tok = fetch_dataset("WikiText2", synthetic=True, synthetic_sizes=LM_SIZES)["train"].token
    rows = batchify(tok, 100)[:, None, :GROUPED_LM_TOKENS]  # [users, 1 row, tokens]
    lm = np.ones((100, cfg["num_tokens"]), np.float32)
    lm[GROUPED_LM_USERS[1], ::3] = 0.0  # the second client misses a third of the vocabulary

    def draws(uid, step):  # at the level's widths
        g = torch.Generator().manual_seed(1000 * uid + step)
        keep = {site: torch.rand((1, cfg["bptt"], F if site % 3 == 2 else E), generator=g)
                < 1.0 - t["dropout"] for site in range(1 + 3 * t["num_layers"])}
        return {"corrupt": torch.rand((1, cfg["bptt"]), generator=g) < cfg["mask_rate"],
                "keep": keep}

    out = {}
    for name, c, engine, dev, hook in (
            ("grouped card", cfg, GroupedRoundEngine, "cuda", draws),
            ("grouped CPU", cfg, GroupedRoundEngine, "cpu", draws),
            ("grouped card, dropout 0", no_dropout, GroupedRoundEngine, "cuda", None),
            ("masked card, dropout 0", no_dropout, RoundEngine, "cuda", None)):
        dev = torch.device(dev)
        model = make_model(c).init_(torch.Generator().manual_seed(0)).to(dev)
        eng = engine(model, c, dev)
        P = eng.flatten(model.params())
        data = (torch.from_numpy(rows).to(dev), torch.from_numpy(lm).to(dev))
        new, ms = eng.train_round(P, c["lr"], list(GROUPED_LM_USERS), data, 0, lm_draws=hook)
        if not torch.equal(eng.spec.leaf(new, "embedding.tok.w")[-1],
                           eng.spec.leaf(P, "embedding.tok.w")[-1]):
            raise AssertionError(f"grouped LM round ({name}): the <mask> embedding row moved")
        out[name] = (new.cpu(), ms["loss_sum"].cpu(), ms["n"].cpu())
    card, cpu = out["grouped card"], out["grouped CPU"]
    d, dl = float((card[0] - cpu[0]).abs().max()), float((card[1] - cpu[1]).abs().max())
    say(f"grouped LM round at full width, users {list(GROUPED_LM_USERS)} (level b, G = 2, "
        f"{GROUPED_LM_TOKENS // cfg['bptt']} steps), card vs CPU: max |params diff| {d:.3e}, "
        f"max |loss_sum diff| {dl:.3e} (tolerance {TOL_LM_ROUND:g}); n {card[2].tolist()}")
    if not (d <= TOL_LM_ROUND and dl <= 100 * TOL_LM_ROUND and torch.equal(card[2], cpu[2])):
        raise AssertionError("grouped LM round: the card disagrees with the CPU")
    g0, m0 = out["grouped card, dropout 0"], out["masked card, dropout 0"]
    assert_close("grouped LM round vs masked on the card, dropout 0: params", g0[0], m0[0],
                 rtol=TOL_GROUPED[0], atol=TOL_GROUPED[1])
    if not torch.equal(g0[2], m0[2]):
        raise AssertionError("grouped LM round, dropout 0: n differs from the masked engine's")


def round_time_phase(torch, out_dir: str, local_epochs: int) -> None:
    """The headline control's first ``TIMED_ROUNDS`` rounds under the masked
    and the grouped engine in one process, through
    ``FedExperiment.train_round`` (the round the entry runs; its evaluation
    and checkpoint, which do not depend on the engine, left out) with the
    control's own sampler: the two experiments draw from the same seed, so
    they train the same cohorts (asserted).  Rounds are taken in turns
    (masked first on odd rounds, grouped first on even ones).  Each grouped
    round's (level, G) shapes are printed with how many this process meets
    for the first time (a cold shape pays cuDNN's plan and the gather map);
    the totals over all rounds and over rounds 2 on are compared."""
    from heterofl_tpu_torch.entry.common import FedExperiment, parse_cfg

    exps, P = {}, {}
    for strategy in ("masked", "grouped"):
        cfg = parse_cfg("round time", "resnet18", "CIFAR10", fed_argv(
            os.path.join(out_dir, strategy), "dense", local_epochs, TIMED_ROUNDS,
            "--strategy", strategy))
        exp = FedExperiment(cfg, cfg["init_seed"])
        exp.stage(*exp.make_splits())
        exps[strategy], P[strategy] = exp, exp.engine.flatten(exp.model.params())
    secs = {"masked": [], "grouped": []}
    seen = set()
    for epoch in range(1, TIMED_ROUNDS + 1):
        for strategy in ("masked", "grouped") if epoch % 2 else ("grouped", "masked"):
            exp = exps[strategy]
            exp.logger.safe(True)
            P[strategy] = exp.train_round(P[strategy], epoch, exp.scheduler(epoch))
            exp.logger.safe(False)
            exp.logger.reset()
            secs[strategy].append(exp.history[-1]["seconds"])
        m, g = exps["masked"].history[-1], exps["grouped"].history[-1]
        if m["users"] != g["users"] or m["user_rates"] != g["user_rates"] or not all(
                math.isfinite(r["loss"]) for r in (m, g)):
            raise AssertionError(f"round {epoch}: the two engines trained other cohorts or a "
                                 f"loss is not finite: {m}, {g}")
        shapes = sorted({(r, g["user_rates"].count(r)) for r in g["user_rates"]}, reverse=True)
        new = [sh for sh in shapes if sh not in seen]
        seen.update(shapes)
        say(f"timed round {epoch}: masked {secs['masked'][-1]:.3f} s, grouped "
            f"{secs['grouped'][-1]:.3f} s ({secs['grouped'][-1] / secs['masked'][-1]:.3f}x); "
            f"levels (rate, G) {shapes}, {len(new)} met for the first time; loss masked "
            f"{m['loss']:.4f} grouped {g['loss']:.4f}")
    for first, what in ((0, "all rounds"), (1, "rounds 2 on")):
        tm, tg = sum(secs["masked"][first:]), sum(secs["grouped"][first:])
        say(f"timed rounds, {what}: masked {tm:.3f} s, grouped {tg:.3f} s, grouped / masked "
            f"{tg / tm:.3f} (the control's own cohorts, one process)")
    del exps, P
    torch.cuda.empty_cache()


def grouped_path(torch, counters, out_dir: str, local_epochs: int):
    """``train_classifier_fed --strategy grouped`` on the headline control at
    full width: ``GROUPED_ROUNDS`` rounds of pinned cohorts (two clients a
    level, so every level runs G = 2), evaluated after the last, a
    checkpoint each; the batched kernels' launches are the steps times the
    sites times the levels present (BN) and the steps times the levels
    present (SGD), and no one-client kernel runs.  Then the last round
    again from the checkpoint generation before it (``--resume_mode 1``),
    equal to the uninterrupted last round bit for bit, as the entry runs
    it (the engine selects cuDNN's deterministic algorithms for its rounds
    and puts the setting back after) -> (launches, launches of the resumed
    round).  The pinned cohorts fix the launch counts; the round time on
    the control's own cohorts is ``round_time_phase``'s."""
    import shutil

    import numpy as np

    from heterofl_tpu_torch.entry import common, train_classifier_fed
    from heterofl_tpu_torch.utils import checkpoint_path
    from heterofl_tpu_torch.utils.checkpoint import generation_path

    # two clients at each of the five levels (users 20 l .. 20 l + 19 are at
    # level l), other ones each round
    cohorts = {e: np.array([20 * lvl + 2 * (e - 1) + i for lvl in range(5) for i in (0, 1)],
                           np.int64) for e in range(1, GROUPED_ROUNDS + 1)}
    sample_users = common.FedExperiment.sample_users
    common.FedExperiment.sample_users = lambda self, epoch: cohorts[epoch]
    steps = local_epochs * (SIZES["train"] // 100 // BATCH)
    extra = ("--strategy", "grouped", "--eval_interval", str(GROUPED_ROUNDS))
    try:
        argv = fed_argv(out_dir, "dense", local_epochs, GROUPED_ROUNDS, *extra)
        say(f"grouped path: train_classifier_fed {' '.join(argv)}")
        zero(counters)
        t0 = time.time()
        (result,) = train_classifier_fed.main(argv)
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = read(counters)
        hist = result["history"]
        levels = [len(set(r["user_rates"])) for r in hist]
        say(f"grouped path: {secs:.1f} s for {len(hist)} rounds; launches {launches}")
        for r, nl in zip(hist, levels):
            say(f"  round {r['epoch']}: users {r['users']} rates {r['user_rates']} ({nl} levels "
                f"present, {nl * steps} batched steps); loss {r['loss']:.4f} accuracy "
                f"{r['accuracy']:.2f}% in {r['seconds']:.2f} s")
        say_checkpoints("grouped path", hist)
        last = hist[-1]
        say(f"  evaluation after round {last['epoch']}: Local accuracy "
            f"{last['Local-Accuracy']:.2f}%, Global loss {last['Global-Loss']:.4f} accuracy "
            f"{last['Global-Accuracy']:.2f}% in {last['eval_seconds']:.2f} s")
        want = {"bn_fwd_batched": BN_SITES * steps * sum(levels),
                "bn_bwd_batched": BN_SITES * steps * sum(levels),
                "fused_sgd_batched": steps * sum(levels), "bn_fwd": 0, "bn_bwd": 0,
                "fused_sgd": 0, "quant_pack": 0}
        if launches != want or len(hist) != GROUPED_ROUNDS or not all(
                math.isfinite(r["loss"]) for r in hist) or not math.isfinite(last["Global-Loss"]):
            raise AssertionError(f"grouped path: launches {launches} (expected {want}), "
                                 f"history {hist}")
        full = {k: v.detach().cpu() for k, v in result["params"].items()}
        del result
        res_dir = out_dir + "_resumed"
        live = checkpoint_path(out_dir, TAG)
        os.makedirs(os.path.dirname(checkpoint_path(res_dir, TAG)))
        shutil.copy(generation_path(live, 1), checkpoint_path(res_dir, TAG))
        zero(counters)
        (res,) = train_classifier_fed.main(
            fed_argv(res_dir, "dense", local_epochs, GROUPED_ROUNDS, *extra, "--resume_mode", "1"))
        torch.cuda.synchronize()
        resumed = read(counters)
    finally:
        common.FedExperiment.sample_users = sample_users
    if torch.backends.cudnn.deterministic:
        raise AssertionError("grouped path: cuDNN's deterministic setting was left on")
    (rec,) = res["history"]
    diff = max(float((res["params"][k].detach().cpu() - v).abs().max()) for k, v in full.items())
    bits = all(torch.equal(res["params"][k].detach().cpu(), v) for k, v in full.items())
    say(f"grouped resumed round: trained round {rec['epoch']} from the round-"
        f"{GROUPED_ROUNDS - 1} checkpoint in "
        f"{rec['seconds']:.2f} s; against the uninterrupted round {GROUPED_ROUNDS}: max |params "
        f"diff| {diff:.3e}, equal bit for bit: {bits}; launches "
        f"{resumed}")
    if not (rec["epoch"] == GROUPED_ROUNDS and bits
            and resumed["fused_sgd_batched"] == steps * levels[-1]):
        raise AssertionError("grouped resumed round: it does not equal the uninterrupted run")
    return launches, resumed


def grouped_lm_path(torch, counters, out_dir: str):
    """One round of ``train_transformer_fed --strategy grouped`` on the LM
    control at full width: its one client a round trains ``LM_STEPS``
    batched steps (one batched fused-SGD call each, no one-client kernel,
    no BN), the ``<mask>`` row kept -> launches."""
    from heterofl_tpu_torch.entry import train_transformer_fed

    argv = lm_argv(out_dir, 1, "--strategy", "grouped")
    say(f"grouped LM path: train_transformer_fed {' '.join(argv)}")
    zero(counters)
    t0 = time.time()
    (result,) = train_transformer_fed.main(argv)
    torch.cuda.synchronize()
    launches = read(counters)
    (r,) = result["history"]
    say(f"grouped LM path: {time.time() - t0:.1f} s; launches {launches}; round 1 loss "
        f"{r['loss']:.4f} perplexity {r['perplexity']:.2f} in {r['seconds']:.2f} s "
        f"({1e3 * r['seconds'] / LM_STEPS:.2f} ms a step); Global perplexity "
        f"{r['Global-Perplexity']:.2f}")
    want = {"bn_fwd": 0, "bn_bwd": 0, "fused_sgd": 0, "quant_pack": 0, "bn_fwd_batched": 0,
            "bn_bwd_batched": 0, "fused_sgd_batched": LM_STEPS}
    if launches != want or not all(math.isfinite(r[k]) for k in
                                   ("loss", "perplexity", "Global-Perplexity")):
        raise AssertionError(f"grouped LM path: launches {launches} (expected {want}), {r}")
    mask_row_kept(torch, result["params"])
    return launches


class Phases:
    """Seconds of each phase, printed as each ends."""

    def __init__(self):
        self.t0 = self.last = time.time()
        self.secs = {}

    def done(self, name: str) -> None:
        now = time.time()
        self.secs[name] = now - self.last
        self.last = now
        say(f"phase {name}: {self.secs[name]:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--local-epochs", type=int, default=1,
                        help="local epochs of the main paths (the control's own is 5)")
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

    phases = Phases()
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
    phases.done("build")

    # 3-4. kernels against their plain versions, then timed
    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(HEADLINE)
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    model = make_model(cfg)
    spec = FlatSpec.of(dict(model.named_parameters()))
    mask_flat = spec.flatten({k: param_mask(s, model.specs[k], model.groups, 0.25)
                              for k, s in spec.shapes.items()}).cuda()
    bn = bn_phase(torch, fused_norm, r50_bn_shapes(torch))
    phases.done("batch norm held and timed")
    sgd = sgd_phase(torch, fused_update, mask_flat)
    del mask_flat
    # and at ResNet-50's n, its level-c width mask
    r50_model = make_model(r50_cfg())
    r50_spec = FlatSpec.of(dict(r50_model.named_parameters()))
    if r50_spec.total != R50_N:
        raise AssertionError(f"ResNet-50 has {r50_spec.total} params, not {R50_N}")
    r50_mask = r50_spec.flatten({k: param_mask(s, r50_model.specs[k], r50_model.groups, 0.25)
                                 for k, s in r50_spec.shapes.items()}).cuda()
    sgd_r50 = sgd_phase(torch, fused_update, r50_mask)
    del r50_mask, r50_model
    P = spec.flatten(dict(model.init_(torch.Generator().manual_seed(0)).named_parameters()))
    qp = quant_phase(torch, quant, codecs, spec, P.detach().cuda())
    del P
    # the same two kernels at the full-width transformer's n, the level-e
    # (per-head) width mask
    lm_model = make_model(lm_cfg())
    lm_spec = FlatSpec.of(dict(lm_model.named_parameters()))
    if lm_spec.total != LM_N:
        raise AssertionError(f"the full-width transformer has {lm_spec.total} params, not {LM_N}")
    lm_mask = lm_spec.flatten({k: param_mask(s, lm_model.specs[k], lm_model.groups, 0.0625)
                               for k, s in lm_spec.shapes.items()}).cuda()
    say(f"transformer at level e: {int(lm_mask.sum())} of {LM_N} params active")
    sgd_lm = sgd_phase(torch, fused_update, lm_mask)
    del lm_mask
    P = lm_spec.flatten(dict(lm_model.init_(torch.Generator().manual_seed(0)).named_parameters()))
    qp_lm = quant_phase(torch, quant, codecs, lm_spec, P.detach().cuda())
    del P, lm_model
    torch.cuda.empty_cache()
    phases.done("fused SGD and quant held and timed")
    bn_b = bn_batched_phase(torch, fused_norm)
    level_e = FlatSpec.of(dict(make_model(cfg, 0.0625).named_parameters())).total
    sgd_b = sgd_batched_phase(torch, fused_update, {1.0: spec.total, 0.0625: level_e})
    phases.done("batched kernels held and timed")

    # 5. small rounds against the CPU, then the main paths, each counted
    counters = (fused_norm.LAUNCHES, fused_update.LAUNCHES, quant.LAUNCHES)
    small_round_phase(torch, "dense")
    small_round_phase(torch, "int8")
    for norm in SMALL_NORMS:
        small_round_phase(torch, "dense", norm)
    lm_round_phase(torch)
    phases.done("small rounds and the LM round against the CPU")
    for model_name in ("conv", "resnet18"):
        grouped_small_round_phase(torch, model_name)
    grouped_lm_round_phase(torch)
    phases.done("grouped small rounds and LM round against the CPU, sliced and masked")
    by_path = {}
    by_path["resnet50_round"], r50_step_ms = resnet50_phase(torch, counters)
    phases.done("ResNet-50 round against the CPU, and its step")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        dense_dir, int8_dir = os.path.join(tmp, "dense"), os.path.join(tmp, "int8")
        dense, dense_res, _ = main_path(torch, counters, "dense", args.local_epochs, dense_dir,
                                        ROUNDS)
        del dense_res
        if dense["quant_pack"] != 0 or min(dense[k] for k in ("bn_fwd", "bn_bwd",
                                                               "fused_sgd")) <= 0:
            raise AssertionError(f"dense main path: unexpected launches {dense}")
        by_path["dense"] = dense
        phases.done("dense main path")
        by_path["dense_resumed"], _ = resume_path(torch, counters, "dense",
                                                  args.local_epochs, dense_dir)
        phases.done("dense resumed round")
        round_time_phase(torch, os.path.join(tmp, "timed"), args.local_epochs)
        phases.done("masked and grouped rounds timed in turns")
        by_path["grouped"], by_path["grouped_resumed"] = grouped_path(
            torch, counters, os.path.join(tmp, "grouped"), args.local_epochs)
        phases.done("grouped path and its resumed round")
        launches, result, _ = main_path(torch, counters, "int8", args.local_epochs,
                                        int8_dir, ROUNDS)
        if launches["quant_pack"] != ROUNDS:
            raise AssertionError(f"int8 main path: quant_pack launched {launches['quant_pack']} "
                                 f"times, expected one per round ({ROUNDS})")
        by_path["int8"] = launches
        params = result["params"]
        if set(params) != set(spec.names) or any(
                tuple(v.shape) != spec.shapes[k] or not bool(torch.isfinite(v).all())
                for k, v in params.items()):
            raise AssertionError("main path: new global params are not finite at the model's "
                                 "shapes")
        resid = result["wire_resid"]
        if resid.shape != (1, spec.total) or not np.isfinite(resid).all() or not resid.any():
            raise AssertionError("int8 main path: the error-feedback residual is not a finite, "
                                 "non-zero [1, n] carry")
        del result, params
        phases.done("int8 main path")
        by_path["int8_resumed"], _ = resume_path(torch, counters, "int8",
                                                 args.local_epochs, int8_dir)
        if by_path["int8_resumed"]["quant_pack"] != 1:
            raise AssertionError(f"int8 resumed round: launches {by_path['int8_resumed']}")
        phases.done("int8 resumed round")
        test_entry_phase(int8_dir, "int8", args.local_epochs)
        phases.done("test_classifier_fed")
        by_path["central"] = central_phase(torch, counters, os.path.join(tmp, "central"))
        phases.done("centralised baseline and test_classifier")
        data_dir = os.path.join(tmp, "data")
        readers_phase(data_dir)
        phases.done("readers: CIFAR10 and EMNIST files")
        by_path.update(dynamic_path(torch, counters, data_dir, tmp))
        phases.done("dynamic path on the CIFAR10 files, and its resumed round")
        by_path["emnist_gn"], t_stats, t_stats_read = emnist_path(torch, counters, data_dir, tmp)
        phases.done("EMNIST path (gn, computed statistics)")
        by_path.update(lm_phases(torch, counters, tmp, phases))
        by_path["lm_grouped"] = grouped_lm_path(torch, counters, os.path.join(tmp, "lm_grouped"))
        phases.done("grouped LM round")
    say("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phases.secs.items())
        + f"; total {time.time() - phases.t0:.1f} s")

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
                        "library_ms": r.get("library_ms"), "device_ms": r["device_ms"],
                        "launches_by_path": {p: n[name] for p, n in by_path.items()}})
        if r is sgd or r is qp:  # and at the transformer's n
            lm = sgd_lm if r is sgd else qp_lm
            kernels[-1].update(max_abs_err=max(r["err"], lm["err"]), lm_n=LM_N, lm_ms=lm["ms"],
                               lm_device_ms=lm["device_ms"], lm_plain_ms=lm["plain_ms"],
                               lm_bound_ms=lm["bound_ms"], lm_max_abs_err=lm["err"])
        if r is sgd:  # and at ResNet-50's n
            kernels[-1].update(max_abs_err=max(kernels[-1]["max_abs_err"], sgd_r50["err"]),
                               r50_n=R50_N, r50_ms=sgd_r50["ms"],
                               r50_device_ms=sgd_r50["device_ms"],
                               r50_plain_ms=sgd_r50["plain_ms"], r50_bound_ms=sgd_r50["bound_ms"],
                               r50_max_abs_err=sgd_r50["err"], r50_step_ms=r50_step_ms)
        if name.startswith("bn_"):
            kernels[-1].update(
                library_device_ms=r["library_device_ms"], central_ms=r["central_ms"],
                central_library_ms=r["central_library_ms"],
                central_device_ms=r["central_device_ms"],
                central_library_device_ms=r["central_library_device_ms"],
                central_plain_ms=r["central_plain_ms"], central_bound_ms=r["central_bound_ms"],
                r50_ms=r["r50_ms"], r50_device_ms=r["r50_device_ms"],
                r50_plain_ms=r["r50_plain_ms"], r50_library_ms=r["r50_library_ms"],
                r50_library_device_ms=r["r50_library_device_ms"],
                r50_bound_ms=r["r50_bound_ms"], r50_sites=R50_SITES,
                r50_by_shape=r["r50_by_shape"])
    for name, r, src, repl in (
            ("bn_fwd_batched", bn_b["bn_fwd_batched"], "heterofl_tpu_torch/csrc/bn.cu",
             "heterofl_tpu/ops/pallas_norm.py:115"),
            ("bn_bwd_batched", bn_b["bn_bwd_batched"], "heterofl_tpu_torch/csrc/bn.cu",
             "heterofl_tpu/ops/pallas_norm.py:140"),
            ("fused_sgd_batched", sgd_b, "heterofl_tpu_torch/csrc/fused_sgd.cu",
             "heterofl_tpu/ops/fused_update.py:207")):
        n = by_path["grouped"][name]
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the grouped path")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": n, "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": "bytes" if r["bytes"] / BW >= r["ops"] / F32
                        else "operations",
                        "library_ms": None, "device_ms": r["device_ms"],
                        "by_level": r["by_level"],
                        "launches_by_path": {p: c[name] for p, c in by_path.items()}})
    say(f"EMNIST statistics: computed in {t_stats:.3f} s, read in {t_stats_read * 1e3:.2f} ms; "
        f"ResNet-50 step {r50_step_ms:.2f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
