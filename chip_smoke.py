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
   headline control on full-width ResNet-18, synthetic CIFAR10 at 3,000 of
   its real 50,000 train images, ``pallas_norm=1``, ``fused_update=1``, one
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
   1,044,314 / 122,785 tokens (half the quoted test tokens) -- two rounds
   (``LM_ROUNDS``) of 164 local steps each, a checkpoint and a Global
   evaluation (192 windows of [10, 64]) each round; the same entry
   resumed for a third round (``--resume_mode 1``, from the checkpoint's
   params bit for bit); ``test_transformer_fed``
   reproducing the best checkpoint's logged Global-Perplexity; one int8
   round; the centralised ``train_transformer`` (one epoch of 164 steps of
   [100, 64]) and ``test_transformer``.  The ``<mask>`` row of the token
   embedding must keep its initial value through every round, and no LM
   path may launch a batch-norm kernel;
7. the grouped engine (``--strategy grouped``): the batched batch-norm
   kernels held against their plain version at ResNet-18's site shapes for
   every level and G in {1, 2, 4} (at level e a channel tile holds several
   clients; a padding sample with a NaN) and at ragged shapes whose tiles
   straddle clients of 1, 3, 4 and 6 channels, and timed over a step at
   G = 2, levels a and e, beside the step's launch floor (the empty kernel
   on each site's plan) and ``F.batch_norm`` on the same activations (a
   yardstick, not the same function: no weights, one count); the batched
   fused SGD (one launch) in the grouped engine's padded ``[G, n_l]`` rows
   at ResNet-18's n at every level for G in {1, 2, 3, 4, 6}, the LM's
   levels a and e and an odd n (also unpadded), on both routes where a row
   has at most 16 parts -- each row bit for bit the one-client kernel's, two
   calls equal -- and timed at level a G 2, level e G 4 and the LM's level a
   G 2 beside its launch floor and ``torch._fused_sgd_`` (a yardstick, not
   the same function: no mask, no clip), its kernels a call counted in a
   ``torch.profiler`` trace (one, or the phase fails; row 3's too); small
   grouped rounds (conv net, ResNet-18 at 8/16/16/16) on the card against
   the CPU, the sliced twin and the masked engine, and a full-width grouped LM round of two
   level-b clients against the CPU and, at dropout 0, the masked engine;
   the headline control's first ``TIMED_ROUNDS`` rounds under the masked
   and the grouped engine in turns, on the control's own cohorts;
   ``train_classifier_fed --strategy grouped`` on the headline control,
   ``GROUPED_ROUNDS`` rounds of two clients a level (the batched kernels'
   launches asserted, no one-client kernel), its last round resumed equal
   bit for bit as the entry runs it; one grouped LM round of the entry;
8. the superstep (``superstep_rounds``): a captured
   augmentation draw replayed three times draws fresh numbers each time,
   equal to eager draws from the same seed; a level-a client's local epoch
   eager against its steps replayed from their captured CUDA graph (bit for
   bit, timed in turns, kernels a replayed step and the device's busy share
   from a ``torch.profiler`` trace, where the hand-written kernels counted
   by name must equal the step's captured launches times its replays, and
   the same count for a grouped level-a step of two clients);
   ``train_classifier_fed`` on the
   headline control at full width for two rounds evaluated after the
   second, eagerly and as one superstep (``--superstep_rounds 2``), equal
   bit for bit under cuDNN's deterministic algorithms -- cohorts, params,
   round metrics, the fused evaluation's Local and Global metrics -- with
   the two runs' host-clock seconds, the rounds' and evaluation's seconds
   (host clock eager, device clock in the superstep), the captures, the
   graph pools' megabytes and the launches a step under replay; the
   grouped engine's superstep with ``--wire_codec int8`` at full width for
   three rounds (a superstep of two and the tail of one), and round 3
   again resumed from the superstep boundary, equal bit for bit; the LM
   control's superstep of two rounds at full width against the LM main
   path's eager rounds;
9. bfloat16 compute, the im2col convolution and the per-level codec map:
   bf16 products accumulated in float32 (cuDNN's convolutions under the
   deterministic algorithms, the im2col batched matmul, a linear layer,
   each against the float32 op on the same bf16 operands); the graph
   checks of phase 8 under ``--compute_dtype bfloat16`` (a replayed bf16
   epoch bit for bit the eager one, its BN and SGD kernels counted by name
   -- their wrappers take float32 operands only); the headline superstep
   of phase 8 in bf16 against its eager bf16 rounds bit for bit, its round
   and evaluation seconds beside float32's; the LM control's bf16
   superstep against its eager bf16 rounds bit for bit; one headline round
   with ``--conv_impl im2col``, masked and grouped (two clients a level),
   against the direct round from the same seed (params within
   ``TOL_IM2COL``); the grouped superstep with the per-level map
   ``CODEC_MAP`` (three rounds, round 3 resumed at the superstep boundary
   equal bit for bit, params and the concatenated residual), and the
   quantise-and-pack kernel held and timed at its int8 levels' sliced n;
10. the client scheduler (``--schedule``, ``--client_failure_rate``), its
   paths cut to ``SCENARIO_SIZES`` (three steps a client, one evaluation a
   run): (a) the fused SGD with ``has`` 0 leaves its buffers bit for bit,
   and kernel 3b at (level a, G 2) and (level e, G 4) with ``has`` rows
   ``[1, 0, ...]`` leaves the gated rows bit for bit and gives the live row
   the one-client kernel's bits; (b) the masked headline with markov
   availability, a deadline, buffered aggregation and client failures,
   three rounds eagerly and as supersteps, equal bit for bit, its steps
   (launches and replays) equal to the budgets of the clients that
   trained, and round 3 resumed from the boundary checkpoint (its
   ``sched_buf`` non-zero) equal to the uninterrupted run; (c) the grouped
   headline superstep with a trace that leaves slots unfilled, a deadline
   and buffered aggregation, resumed at the boundary bit for bit, kernel
   3b replayed to each level's largest budget; one grouped int8 round with
   unfilled slots on the card against the CPU; (d) the LM control's
   superstep with a deadline and buffered aggregation against its K=1
   rounds bit for bit.  Each run prints its host-clock seconds, its steps
   against the lockstep budget, its slots filled and failed and its
   kernels by name;
11. the streaming client store (``--client_store stream``), at phase 10's
   depth: (a) the masked headline streamed against the eager store, three
   rounds at K=1 and five at ``--superstep_rounds 2
   --stream_prefetch_depth 2``, params, log and launches bit for bit, and
   the superstep run resumed from its round-2 checkpoint (written with two
   cohorts already prefetched) equal to the uninterrupted run; (b) the
   grouped headline superstep streamed against the eager store bit for
   bit, the eager store's refusal of int8 at K=1, and that streamed int8
   K=1 round on the card against the CPU under phase 10c's contract; (c)
   the LM control's superstep streamed against the eager store bit for
   bit; (d) span stores of 10,000 and 1,000,000 users over 15,000
   synthetic CIFAR10 images (shard 500, prp, A = 10): ``stage_cohort``'s
   host seconds, the device bytes it allocates (equal at both
   populations) and the store's metadata bytes, staging at 1e6 users
   under 5x the seconds at 1e4, and one streamed superstep of two rounds
   on full-width ResNet-18 from the 1e6 cohort trains; (e) the cohort ring
   at depth 1 and 2: cohorts staged while the superstep before them runs,
   each copied out on the compute stream after its superstep equal to the
   host gather bit for bit, and whether each prefetch ended while the
   device was still busy (``Event.query``);
12. observability and its guards (``--telemetry``, ``--ledger``,
   ``--trace_dir``, ``--profile_dir``, ``--quarantine``, ``--chaos_poison``,
   ``--watchdog``), at phase 10's depth: (a) the masked headline superstep
   under ``hist`` with the ledger, the trace and a profile against the
   plain run, bit for bit (params, log, launches, replays), one metrics
   fetch a superstep in both, every record finite, the trace, the ledger's
   report and the profile's kernel names read back; the one-round tail's
   ``update_norm`` against the norm of its fetched params minus the
   checkpoint's before it (1e-5 relative); the probes' kernels a round and
   the gate's a client (the kernel nodes of a captured call); the tail's
   device seconds off and on; (b) the
   grouped superstep and the LM superstep under ``on`` against their plain
   runs, bit for bit; (c) ``chaos_poison`` under the gate, masked and
   grouped: finite params, ``quarantined`` the poisoned count; (d) a
   poisoned run under ``watchdog={'action': 'rollback'}`` recovering;
13. experiment arms and the chaos drill, at the headline's full width on
   ``ARMS_SIZES`` (a local step a client): (a) the masked superstep of two
   rounds as E=2 arms (seeds ``[None, 1]``, learning-rate scales ``[1,
   0.5]``) through ``ArmsExperiment``, arm 0 against the plain run and
   arm 1 against its solo arms run bit for bit, one ``host_fetch`` a
   superstep, rows 1-3 replayed E times the solo run's, the E-arm
   superstep's device seconds beside the plain and solo ones, all under
   ``--wire_codec int8``; (b) the same for the grouped engine (dense) and
   rows 1b-3b; (c) the masked int8 arms' round 2 resumed from the round-1
   blob equal to the uninterrupted run (params and per-arm residuals),
   quantise-and-pack a round an arm; (d) the chaos drill
   (``chaos.drill``): kills at superstep, fetch and checkpoint, masked (K
   2) and grouped (K 1), a prefetch kill under the stream store and a
   corrupted live blob falling back a generation, each resume equal to
   the uninterrupted run bit for bit; the poison drill in ``quarantine``
   and ``rollback`` modes; all under cuDNN's deterministic algorithms;
14. the model profile and the runtime audit: (a)
   ``analysis.process`` over the result bundles the earlier phases' test
   entries wrote, each aggregate equal to its bundle's logged metric and
   in the csv; (b) ``analysis.summary.make_summary`` at full width on the
   card for the headline ResNet-18, the MNIST conv twin and the
   transformer, levels a-e, ``num_params`` equal to the CPU's
   ``fed.core.level_param_table`` and ``FlopCounterMode``'s forward FLOPs
   on the card equal to the CPU's, each level's params, FLOPs a step and
   wire bytes printed; (c) ``python -m heterofl_tpu_torch.staticcheck
   --device cuda --flagship --diff-baseline`` in-process with zero
   findings against ``baseline.json``'s ``cuda`` section (launches a
   replayed step, captures, graph pool and peak MB, wire bytes of each
   program printed; every kernel launched under it); (d) the model FLOP
   rate of a replayed masked level-a step (``level_flop_table`` over its
   device ms) beside the card's name and power limit;
15. the clients mesh axis (``parallel/mesh.py``, ``parallel/pod.py``), at
   full width on ``MESH_SIZES`` (a local step a client): (a) the
   headline masked path -- K=1 and a superstep of two rounds, dense and
   int8 -- without a process group and then as rank 0 of a one-rank NCCL
   group (the entries joining it as under torchrun), equal bit for bit
   under cuDNN's deterministic algorithms (cohorts, logs, params,
   residual), each NCCL run's collectives counted (one all-reduce a round
   and one an sBN and a Global pass, one gather a round's or a
   superstep's rows and one a Local pass); (b) the round's one all-reduce
   at the flagship's payloads -- the dense ``[2, 11,172,170]`` float32 and
   the int8 codec's packed words -- timed on CUDA events through the
   wrapper and bare, with its bytes, and its kernels' names from a
   profiler trace where NCCL launches any; (c) two gloo ranks sharing the
   card (``chip_smoke.py --mesh-rank``, spawned as torchrun would; NCCL
   across two GPUs where the machine has them), each running the headline
   entry of (a) -- K=1 and superstep, dense and int8, one output
   directory, a checkpoint shard a rank -- then the pod probe's rank: each
   run's ranks equal bit for bit (params and logged losses), the dense
   runs within ``RANKS_ATOL`` of (a)'s one-rank runs (the int8 runs are
   another quantisation at two ranks, each rank its own grid and noise:
   their distance is printed, their residual rows must differ), one
   all-reduce a round and a pass on each rank, each kernel launched on
   each rank; the probe's ranks bit for bit equal, within ``RANKS_ATOL``
   of the probe alone (run in this process), the sharded checkpoint read
   back, each rank's round seconds on the host clock beside the one-rank
   run's (two ranks sharing one GPU: not a scaling figure), and whether
   gloo all-reduces a CUDA tensor itself;
16. the grouped engine on the clients mesh axis (``parallel/grouped.py``
   over ``parallel/mesh.py``), at phase 15's depth and full width: (a) the
   grouped headline -- K=1 and a superstep of two rounds dense, and the
   superstep under ``CODEC_MAP`` -- without a process group and then as
   rank 0 of a one-rank NCCL group, equal bit for bit, one all-reduce a
   round (the map's every level at once) and a pass, the batched kernels
   launched and no one-client kernel; then two gloo ranks sharing the card
   (``chip_smoke.py --gmesh-rank``; NCCL across two GPUs where the machine
   has them), each running: (b) the grouped headline superstep under
   ``span``, on rank 0 inside a profiler trace whose hand-written kernels
   equal the launch counters; (c) ``GMESH_SLICES`` under ``slices`` with
   ``strict_placement``, each rank training only its own level (its
   captured steps' levels recorded); (d) the entry under ``CODEC_MAP`` over
   two supersteps, uninterrupted and resumed from the first's sharded
   checkpoint, equal bit for bit, the ranks' residual rows apart; each
   payload's all-reduce timed on CUDA events with its payload, reduced and
   ring bytes; the grouped LM entry's one round at phase 7's flags (its
   one client on rank 0), within ``RANKS_ATOL`` of phase 7's one-rank
   round, kernel 3b launched on rank 0 only; (e) the grouped slices pod
   probe's rank: each run's ranks equal bit for bit, (b) and (c) within
   ``RANKS_ATOL`` of the one-rank span runs, one all-reduce a round on
   each rank, the batched kernels on each rank, and the probe as phase
   15's; (f) NCCL between two GPUs is (b)-(e)'s backend where the machine
   has them;
17. the data mesh axis (``parallel/mesh.py``'s ``data`` axis,
   ``parallel/ring_attention.py``, ``parallel/long_context.py``): (a) the
   synchronised batch norm's four kernels (``bn_sync_stats``,
   ``bn_sync_apply``, ``bn_sync_bwd_reduce``, ``bn_sync_bwd_apply``)
   against their plain versions at the headline ResNet-18's BN shapes at
   batch 5 (a data rank's half) and 10 (``TOL_SYNC``), a group of one
   through the split pair against ``bn_fwd_cuda``/``bn_bwd_cuda``
   (``TOL_BN``), each timed (call and CUDA-graph replay) beside its plain
   version and the aten op of PyTorch's SyncBatchNorm that does its work
   (``batch_norm_stats``, unweighted, ``batch_norm_elemt``,
   ``batch_norm_backward_reduce``, ``batch_norm_backward_elemt``: timed
   here by call and by CUDA-graph replay, used nowhere in the port); the
   batched pair of the grouped engine (``bn_sync_stats_batched``,
   ``bn_sync_bwd_apply_batched``, with the shared apply and backward
   reduce on the ``[M, G*C]`` columns) at batch 5 for levels a and e at G
   = 2 and level c at G = 3 (a zero-weight sample) against their plain
   versions, two calls equal bit for bit, at G = 1 equal to the one-client
   kernels bit for bit, and timed the same way at levels a and e; (b) two
   gloo ranks sharing the card on the mesh ``(1, 2)`` (``chip_smoke.py
   --data-rank``), each running the headline entry at phase 15's depth --
   K=1 dense, K=1 int8 and a superstep of two rounds, then with
   ``--strategy grouped`` K=1 dense and a superstep of two -- each data
   rank taking 5 of every batch of 10 with BN synchronised over the pair:
   the ranks equal bit for bit, within ``TOL_DATA_RANKS`` of phase 15's
   (masked) and phase 16's (grouped) one-rank runs, which are reused (the
   same draws: the split draws over the whole batch; int8 within
   ``DATA_INT8_SHARE`` of its entries, a grid step), the masked runs
   launching the four kernels and not ``bn_fwd``, the grouped ones
   1bs/2bs and 3b and neither 1b/2b nor the one-client pair's own, the
   clients axis's one all-reduce a round, the data axis's one all-reduce
   a step (a level step) and two a BN site, each engine's first run on
   rank 0 inside a profiler trace whose kernels by name equal its
   counters; (c) the masked and the grouped LM round at ``(1, 2)``
   (dropout 0, ring attention; the grouped one's two users a level-a
   batch of G = 2) and ``SeqParallelLM.forward`` / ``train_step`` against
   one rank with dense attention, within ``TOL_DATA_LM``; (d) NCCL between
   two GPUs where the machine has them, else the reason printed;
18. the ``kernels`` JSON line (launches from the int8 path, the batched
   kernels' from the grouped path, the synchronised pair's from 17b's
   rank 0, the batched synchronised pair's from 17b's grouped runs on rank
   0; per path in ``launches_by_path``, and
   the superstep's launches from replays -- a graph's captured launches
   times its replays -- in ``replayed_launches_by_path``), then the ``ok``
   JSON line last.

Needs one CUDA device; without one it exits non-zero and prints no result.
Everything it measures is printed on standard output.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
TAG = f"0_CIFAR10_label_resnet18_{HEADLINE}"
CENTRAL = "1_1_1_none_fix_a1_bn_1_1"  # the centralised baseline, full width
CENTRAL_TAG = f"0_CIFAR10_label_resnet18_{CENTRAL}"
CENTRAL_EPOCHS = 1
# the vision paths' synthetic CIFAR10: 3,000 of the real 50,000-image train
# set (30 steps a round, 300 sBN forwards; cut for the script's time, from
# 25,000 when the bf16, im2col and codec-map phases came, from 15,000 when
# phase 12 came, from 10,000 when phase 13 came, from 8,000 when phase 16
# came, and from 4,000 when phase 17 came), and 5,000 of the real
# 10,000-image test set (cut when phase 17 came: each evaluation's Global
# and Local passes halved)
SIZES = {"train": 3000, "test": 5000}
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
# process): loss within 1e-4 relative, accuracy within 0.05 points (2.5 of
# the 5,000 test images)
TOL_EVAL_LOSS = 1e-4
TOL_EVAL_ACC = 0.05
# the masked LM: the control of the paper's WikiText2 runs, full width;
# synthetic WikiText2 at half the train tokens quoted for WikiText2 (cut in
# depth from 2,088,628 when phase 16 came: 164 steps a round instead of
# 327) and half its quoted test tokens (245,569 until phase 17 came: 192
# evaluation windows instead of 384)
LM_CONTROL = "1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
LM_TAG = f"0_WikiText2_label_transformer_{LM_CONTROL}"
LM_CENTRAL_TAG = f"0_WikiText2_label_transformer_{CENTRAL}"
LM_SIZES = {"train": 1044314, "test": 122785}
LM_N = 2454528          # the full-width transformer's parameters (vocabulary 512)
LM_STEPS = math.ceil(LM_SIZES["train"] // 100 / 64)  # 164: 10,443 tokens a user, bptt 64
LM_ROUNDS = 2  # cut from 3 for the superstep paths' time
# the card-vs-CPU LM rounds: (user, tokens of its row): level a over 10
# windows, level e over 2 (lm_round_phase says why)
LM_ROUND_CLIENTS = ((0, 640), (99, 128))
TOL_LM_ROUND = 1e-3     # max |params| difference, card LM round vs CPU LM round
# the sixth slice: dynamic rates on data read from disk, the group norms and
# the bottleneck ResNet.  The dataset files are written in their real
# on-disk formats from a seed: CIFAR10 as the python-pickle batches, cut in
# depth to the vision paths' 3,000 training images (five batches of 600)
# and 5,000 test images; EMNIST balanced as gzip IDX, cut from
# 112,800 / 18,800 images to EMNIST_SIZES.
DYNAMIC = "1_100_0.1_iid_dynamic_a1-b1-c1-d1-e1_bn_1_1"
DYN_TAG = f"0_CIFAR10_label_resnet18_{DYNAMIC}"
DYN_ROUNDS = 2
MODE_RATES = {1.0, 0.5, 0.25, 0.125, 0.0625}
CIFAR_BATCH_ROWS = SIZES["train"] // 5  # the distribution's five train batches
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
SGD_BATCHED_G = (1, 2, 3, 4, 6)                  # kernel 3b held at every level with these G
SGD_BATCHED_TIMED = ((1.0, 2), (0.0625, 4))      # (rate, G) of its timed ResNet-18 shapes
SGD_ODD_N = 10_001                               # an odd n (3 parts: both routes)
# batched BN at ragged shapes, (M, C a client, P, G): clients of 1, 3, 4 and 6
# channels, so channel tiles straddle clients; odd widths take the scalar path
BN_BATCHED_RAGGED = [(999, 1, 111, 5), (3000, 3, 300, 4), (1960, 4, 196, 3), (490, 6, 49, 5),
                     (7840, 6, 784, 2)]
GROUPED_ROUNDS = 2  # pinned cohorts: round 1, then round 2, which is resumed
# masked and grouped rounds in turns, the control's own cohorts (cut from 8 for
# the superstep paths' time)
TIMED_ROUNDS = 4
# the grouped LM round on the card: two level-b clients of the LM control
# (users 20 l .. 20 l + 19 are at level l), 4 windows of bptt 64 each
GROUPED_LM_USERS = (20, 21)
GROUPED_LM_TOKENS = 256
TOL_GROUPED = (5e-4, 5e-5)  # (rtol, atol): grouped vs masked and vs sliced (tests/test_grouped.py)
SS_ROUNDS = 2  # the superstep paths: one superstep of two rounds
IM2COL_SIZES = {"train": 2000, "test": 1000}  # the im2col rounds: two steps a client
TOL_IM2COL = 1e-3  # max |params| difference, im2col round vs direct round (as TOL_ROUND)
# the per-level map: a dense level, two int8 levels and the other two codecs
CODEC_MAP = {"1": "dense", "0.5": "int8", "0.25": "int8", "0.125": "signsgd", "0.0625": "topk"}
# the client scheduler's paths (phase 10): depth cut to 30 train images a client (3 steps a
# client, a local epoch; 5 until phase 17 and 4 until phase 17's grouped runs needed the
# time), 1,000 test images and one evaluation a run; full widths
SCENARIO_SIZES = {"train": 3000, "test": 1000}
SCENARIO_ROUNDS = 3  # a superstep of two and the clamped tail of one
SCENARIO_MIN_FRAC = 0.5
SCENARIO_FAIL = 0.1
SCENARIO_MASKED = {"kind": "markov", "deadline": {"min_frac": SCENARIO_MIN_FRAC},
                   "aggregation": "buffered"}
SCENARIO_TRACE_AVAIL = (6, 100, 4)  # users available in each round of the grouped trace
SCENARIO_LM_SIZES = {"train": 256000, "test": 24576}  # 40 steps a client
# the streaming store's paths (phase 11), at the scenario paths' depth: K=2 supersteps of rounds
# [1, 2], [3, 4], [5], so depth 2 prefetches two cohorts; the population at the reference's
# acceptance shape (tests/test_streaming.py:384-437), full-width ResNet-18
STREAM_ROUNDS = 5
POP_USERS = (10_000, 1_000_000)
POP_ITEMS = 15000
POP_SHARD = 500
POP_ACTIVE = 10
POP_STAGE_CALLS = 5
POP_TIME_RATIO = 5.0  # the reference's bound, tests/test_streaming.py:430
RING_SHARD = 50  # the ring check's shard: five steps a client
RING_SUPERSTEPS = 4
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
    from heterofl_tpu_torch.parallel.step_graph import gc_paused

    graph = torch.cuda.CUDAGraph()
    with gc_paused(), torch.cuda.graph(graph):
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


#: traces of one run taken before a count from the profiler is given up: a
#: trace loses a block of the card's kernel records now and then, and never
#: adds one (``scripts/torch_port_trace_drops.py`` counts how often)
TRACE_TRIES = 3

#: empty kernels (``torch.cuda._sleep``'s ``spin_kernel``) launched at a
#: trace's start, before the traced work, and left out of every count: the
#: profiler may drop the first few records of a trace (three in a row on
#: one card), and these absorb it
TRACE_PAD = 8
PAD_KERNEL = "spin_kernel"


def trace(fn, cpu: bool = True):
    """``fn()`` run and the card synchronised inside a ``torch.profiler``
    trace, after :data:`TRACE_PAD` empty kernels -> (the profile, the run's
    host-clock ms); ``cpu=False`` records the card's activity alone (a
    whole entry run's host operators cost the trace tens of seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return prof, wall


def device_events(prof) -> list:
    """The names of the card's records in a trace, the pad left out, read
    from the profiler's raw records (``prof.events()`` builds the whole
    event tree first: tens of seconds over a traced entry run)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and PAD_KERNEL not in e.name()]


def kernels_per_call(fn, calls: int = 20):
    """Kernels one call of ``fn`` runs on the card, counted in a
    ``torch.profiler`` trace of ``calls`` calls after a warm-up one (copies
    and fills not counted) and rounded: the profiler may drop a record or
    two beyond the trace's pad (:func:`trace`), and a trace that lost more
    is taken again (up to :data:`TRACE_TRIES`) -> (kernels a call, their
    names)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        prof, _ = trace(lambda: [fn() for _ in range(calls)])
        names = [n for n in device_events(prof) if not n.startswith(("Memcpy", "Memset"))]
        per_call = round(len(names) / calls)
        if per_call >= 1 and abs(len(names) - per_call * calls) <= 2:
            return per_call, sorted(set(names))
        say(f"a profiler trace of {calls} calls holds {len(names)} kernels: traced again")
    raise AssertionError(f"the profiler saw {len(names)} kernels in {calls} calls: "
                         f"{sorted(set(names))}")


def graph_kernels(fn) -> int:
    """Kernels one call of ``fn`` launches, counted as the kernel nodes of
    its capture in a CUDA graph (``heterofl_tpu_torch.staticcheck.kernels.
    graph_kernels``; exact where a profiler trace can lose records)."""
    from heterofl_tpu_torch.staticcheck.kernels import graph_kernels as count

    return count(fn)


#: the device kernel that each launch counter counts, one a counted call
KERNEL_OF = {"bn_fwd": "bn_fwd_kernel", "bn_bwd": "bn_bwd_kernel",
             "bn_fwd_batched": "bn_fwd_batched_kernel", "bn_bwd_batched": "bn_bwd_batched_kernel",
             "fused_sgd": "sgd_apply", "fused_sgd_batched": "sgd_batched_(?:persistent|cluster)",
             "quant_pack": "quant_pack", "bn_sync_stats": "bn_sync_stats_kernel",
             "bn_sync_apply": "bn_sync_apply_kernel",
             "bn_sync_bwd_reduce": "bn_sync_bwd_reduce_kernel",
             "bn_sync_bwd_apply": "bn_sync_bwd_apply_kernel",
             "bn_sync_stats_batched": "bn_sync_stats_batched_kernel",
             "bn_sync_bwd_apply_batched": "bn_sync_bwd_apply_batched_kernel"}


def traced_kernels(prof) -> dict:
    """The hand-written kernels in a ``torch.profiler`` trace, counted by
    name, by launch counter (:data:`KERNEL_OF`)."""
    names = device_events(prof)
    return {k: sum(1 for n in names if re.search(rf"\b{pat}\b", n))
            for k, pat in KERNEL_OF.items()}


def traced_as_captured(run, want: dict, what: str):
    """``run`` traced until the hand-written kernels counted by name in its
    trace (:func:`traced_kernels`) equal ``want``, the captured launches x
    replays: a trace that counts fewer lost records and is taken again, up
    to :data:`TRACE_TRIES` in all; one that counts more fails at once (a
    profiler does not make records up) -> (the profile, the counts, the
    run's host-clock ms)."""
    if not want:
        raise AssertionError(f"{what}: the captured step holds no hand-written kernel")
    for attempt in range(1, TRACE_TRIES + 1):
        prof, wall = trace(run)
        got = traced_kernels(prof)
        if all(got[k] == want.get(k, 0) for k in KERNEL_OF):
            return prof, got, wall
        say(f"{what}: trace {attempt} of {TRACE_TRIES} counted {got} in "
            f"{len(device_events(prof))} device records, not the captured launches x replays "
            f"{want}")
        if any(got[k] > want.get(k, 0) for k in KERNEL_OF):
            break
    raise AssertionError(f"{what}: the kernels a replayed epoch ran {got} are not its captured "
                         f"launches x replays {want}")


def queued_ms(fn, calls: int = BN_GRAPH_CALLS, samples: int = 25) -> float:
    """Device time of one call launched eagerly: ``calls`` calls issued
    behind a sleeping kernel long enough that they all wait in the stream's
    queue, then timed on CUDA events from the sleep's end to the last
    call's; the median over ``samples``, divided by ``calls``.  The launches
    are the program's own, not a graph's, and the host's time between them
    is hidden."""
    import torch

    for _ in range(3):
        fn()
    out = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)  # about 2 ms at the card's clock: longer than the launches
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def floor_call(torch, tiles: int, cluster: int, smem: int, pdl: bool = False):
    """A launcher of the empty kernel on a plan's grid (``tiles`` clusters of
    ``cluster`` blocks, ``smem`` bytes of shared memory; ``hfl_bn_floor``):
    timed, the plan's launch floor.  A measuring aid, on no path."""
    from heterofl_tpu_torch.ops import _build

    lib = _build.load()

    def run():
        _build.check(lib.hfl_bn_floor(tiles, cluster, smem, int(pdl),
                                      torch.cuda.current_stream().cuda_stream), "bn_floor")
    return run


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
    per_call, names = kernels_per_call(
        lambda: fused_update.fused_sgd_cuda(graw, p_k, b_k, mask_flat, scal, **kw))
    nbytes = 6 * 4 * n
    bound = max(nbytes / BW, 10 * n / F32) * 1e3
    say(f"  fused_sgd: kernel {ms:.4f} ms (device {dms:.4f})  plain {pms:.4f} ms  bound "
        f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB); {per_call} kernels a call in a profiler "
        f"trace ({', '.join(names)})")
    return {"ms": ms, "device_ms": dms, "plain_ms": pms, "bound_ms": bound, "err": worst,
            "bytes": nbytes, "ops": 10 * n, "kernels_per_call": per_call}


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
    channel tile of the plan holds several clients -- and at
    ``BN_BATCHED_RAGGED``, then timed over a step's 17 sites for
    ``GROUPED_TIMED``, beside each step's bound, its launch floor (the empty
    kernel on each site's plan, ``floor_call``) and ``F.batch_norm`` on the
    channels_last ``[B, G*C, H, W]`` view with unit weights, a yardstick
    that is not the same function (one count for all columns, no weight) ->
    per kernel, the totals of the first timed (G, level) and ``by_level``
    for each."""
    import torch.nn.functional as F

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(7)
    tot = {k: {"err": 0.0, "by_level": []} for k in ("bn_fwd_batched", "bn_bwd_batched")}
    straddle = 0
    shapes = [(M, level_width(C0, rate), M // BATCH, G)
              for rate in LEVELS for G in GROUPED_G for M, C0, _ in BN_SHAPES]
    for M, C, P, G in shapes + BN_BATCHED_RAGGED:
        pl = fused_norm.bn_plan_batched(M, G * C, C, P)
        straddle += int(G > 1 and (pl.tile_c > C or C % pl.tile_c != 0))
        _, e_f, e_b = bn_batched_check(torch, fused_norm, gen, M, C, P, G)
        tot["bn_fwd_batched"]["err"] = max(tot["bn_fwd_batched"]["err"], e_f)
        tot["bn_bwd_batched"]["err"] = max(tot["bn_bwd_batched"]["err"], e_b)
    say(f"batched BN held at {len(shapes)} (level, G, site) shapes and "
        f"{len(BN_BATCHED_RAGGED)} ragged ones, {straddle} of them with channel tiles holding "
        f"more than one client; bit-identical across two calls")
    pdl = fused_norm.BN_BATCHED_PDL
    keys = ("ms", "plain_ms", "device_ms", "bound_ms", "floor_ms", "yardstick_ms",
            "yardstick_device_ms")
    for G, rate in GROUPED_TIMED:
        t_all = {k: dict.fromkeys(keys + ("bytes", "ops"), 0.0) for k in tot}
        for M, C0, sites in BN_SHAPES:
            C = level_width(C0, rate)
            P = M // BATCH
            (x2, w, g, b, dy, st), _, _ = bn_batched_check(torch, fused_norm, gen, M, C, P, G)
            GC = G * C
            pl = fused_norm.bn_plan_batched(M, GC, C, P)
            x4 = x2.view(BATCH, 1, P, GC).permute(0, 3, 1, 2)
            dy4 = dy.view(BATCH, 1, P, GC).permute(0, 3, 1, 2)
            _, s_mean, s_inv = torch.ops.aten.native_batch_norm(x4, g, b, None, None, True, 0.0,
                                                                1e-5)
            calls = {"bn_fwd_batched": (
                lambda: fused_norm.bn_fwd_batched_cuda(x2, w, P, g, b),
                lambda: fused_norm.bn_fwd_batched_plain(x2, w, P, g, b),
                floor_call(torch, pl.tiles, pl.cluster, pl.smem_fwd, pdl),
                lambda: F.batch_norm(x4, None, None, g, b, training=True, momentum=0.0,
                                     eps=1e-5)),
                     "bn_bwd_batched": (
                lambda: fused_norm.bn_bwd_batched_cuda(x2, w, P, g, dy, st),
                lambda: fused_norm.bn_bwd_batched_plain(x2, w, P, g, dy, st),
                floor_call(torch, pl.tiles, pl.cluster, pl.smem_bwd, pdl),
                lambda: torch.ops.aten.native_batch_norm_backward(
                    dy4, x4, g, None, None, s_mean, s_inv, True, 1e-5, [True, True, True]))}
            nbytes = {"bn_fwd_batched": 4 * (2 * M * GC + G * BATCH + 2 * GC + 3 * GC),
                      "bn_bwd_batched": 4 * (3 * M * GC + G * BATCH + GC + 3 * GC + 2 * GC)}
            nops = {"bn_fwd_batched": 9 * M * GC, "bn_bwd_batched": 14 * M * GC}
            for k, (kern, plain, floor, yard) in calls.items():
                t = {"ms": time_ms(kern, samples=9), "plain_ms": time_ms(plain, samples=9),
                     "device_ms": graph_ms(kern, samples=9),
                     "bound_ms": max(nbytes[k] / BW, nops[k] / F32) * 1e3,
                     "floor_ms": graph_ms(floor, samples=9),
                     "yardstick_ms": time_ms(yard, samples=9),
                     "yardstick_device_ms": graph_ms(yard, samples=9)}
                for key in keys:
                    t_all[k][key] += sites * t[key]
                t_all[k]["bytes"] += sites * nbytes[k]
                t_all[k]["ops"] += sites * nops[k]
        for k, r in t_all.items():
            say(f"{k}, a training step of G={G} clients at level {rate:g} (17 sites): call "
                f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms, launch floor {r['floor_ms']:.4f} ms (dependent "
                f"launches {'on' if pdl else 'off'}); library: none (no PyTorch call takes a "
                f"weight per client and sample); yardstick, not the same function: "
                f"F.batch_norm{' backward' if 'bwd' in k else ''} on [B, G*C, H, W] call "
                f"{r['yardstick_ms']:.4f} ms, device {r['yardstick_device_ms']:.4f} ms")
            tot[k]["by_level"].append({"G": G, "rate": rate, **r})
    for k in tot:
        tot[k].update(tot[k]["by_level"][0])
    return tot


def sgd_floor_call(torch, fused_update, plan, n: int, G: int, sync: bool = False):
    """A launcher of the empty kernel ``hfl_sgd_floor`` on the grid, cluster
    and attributes kernel 3b takes on ``plan`` for G rows of n (with
    ``sync``, and the route's barrier) -> (the launcher, its grid): timed,
    the plan's launch floor.  A measuring aid, on no path."""
    import ctypes

    from heterofl_tpu_torch.ops import _build

    lib = _build.load()
    route = 0 if plan.route == "persistent" else 1
    grid = ctypes.c_int(0)

    def run():
        _build.check(lib.hfl_sgd_floor(route, plan.vec, plan.rows, n, G, int(sync),
                                       ctypes.byref(grid),
                                       torch.cuda.current_stream().cuda_stream), "sgd_floor")
    run()
    torch.cuda.synchronize()
    return run, grid.value


def padded_copy(torch, v, ld: int):
    """A copy of ``v [G, n]`` in rows ``ld`` apart, the pad filled with 7s
    -> (the ``[G, ld]`` rows, the ``[G, n]`` view)."""
    full = torch.full((v.shape[0], ld), 7.0, device=v.device)
    full[:, :v.shape[1]] = v
    return full, full[:, :v.shape[1]]


def sgd_batched_inputs(torch, gen, n: int, G: int, ld: int):
    """Inputs of kernel 3b: ``g, p, buf [G, n]`` views of ``[G, ld]`` rows
    (the pad filled with 7s), a mask with 10% zeros, and ``scal`` in which
    rows 0, 3, ... clip (the rest scaled by 1e-5) and row 1 has ``has`` 0
    -> (g, p, buf, mask, scal, clip)."""
    dev = torch.device("cuda")
    g, p, buf = (padded_copy(torch, torch.randn(G, n, device=dev, generator=gen), ld)[1]
                 for _ in range(3))
    buf.mul_(0.1)
    mask = (torch.rand(n, device=dev, generator=gen) < 0.9).to(torch.float32)
    clip = [i % 3 == 0 for i in range(G)]
    for i in range(G):
        if not clip[i]:
            g[i] *= 1e-5
    scal = torch.tensor([[7.0, 0.1, 0.0 if i == 1 else 1.0] for i in range(G)], device=dev)
    return g, p, buf, mask, scal, clip


def sgd_batched_check(torch, fused_update, gen, n: int, G: int, ld: int) -> float:
    """Kernel 3b at ``[G, n]`` rows ``ld`` apart, on every route its plan
    allows: each row bit for bit the one-client kernel on it, two calls
    equal, the ``has`` 0 row and the pad untouched, the clipped rows within
    ``TOL_SGD_CLIP`` of the plain version and the rest equal to it -> the
    largest difference from the plain version."""
    kw = dict(momentum=0.9, weight_decay=5e-4, max_norm=1.0)
    g, p0, b0, mask, scal, clip = sgd_batched_inputs(torch, gen, n, G, ld)
    p_r, b_r = fused_update.fused_sgd_batched_plain(g, p0, b0, mask, scal, **kw)
    one = []
    for i in range(G):  # the one-client kernel on each row
        pu, bu = p0[i].clone(), b0[i].clone()
        fused_update.fused_sgd_cuda(g[i].clone(), pu, bu, mask, scal[i].clone(), **kw)
        one.append((pu, bu))
    plan = fused_update.sgd_plan_batched(n, G, ld)
    routes = ["persistent"] + (["cluster"] if plan.parts <= fused_update.SGD_CLUSTER_PARTS
                               else [])
    worst = 0.0
    for route in routes:
        pl = fused_update.sgd_plan_batched(n, G, ld, route=route)
        outs = []
        for _ in range(2):
            (p_full, p_k), (b_full, b_k) = padded_copy(torch, p0, ld), padded_copy(torch, b0, ld)
            fused_update.fused_sgd_batched_cuda(g, p_k, b_k, mask, scal, plan=pl, **kw)
            outs.append((p_k, b_k))
        torch.cuda.synchronize()
        (p_k, b_k), (p_2, b_2) = outs
        what = f"n={n} G={G} ld={ld} {route} (vec {pl.vec}, {pl.parts} parts, rows {pl.rows})"
        if not (same_bits(torch, p_k, p_2) and same_bits(torch, b_k, b_2)):
            raise AssertionError(f"fused_sgd_batched {what}: two calls differ")
        if not all(same_bits(torch, pu, p_k[i]) and same_bits(torch, bu, b_k[i])
                   for i, (pu, bu) in enumerate(one)):
            raise AssertionError(f"fused_sgd_batched {what}: a row differs from the one-client "
                                 f"kernel on it")
        if G > 1 and not (same_bits(torch, p_k[1], p0[1]) and same_bits(torch, b_k[1], b0[1])):
            raise AssertionError(f"fused_sgd_batched {what}: the has-0 row moved")
        if ld > n and not (bool((p_full[:, n:] == 7.0).all())
                           and bool((b_full[:, n:] == 7.0).all())):
            raise AssertionError(f"fused_sgd_batched {what}: the pad columns moved")
        clipped = [i for i in range(G) if clip[i] and scal[i, 2] > 0]
        exact = [i for i in range(G) if i not in clipped]
        if not (same_bits(torch, p_k[exact], p_r[exact])
                and same_bits(torch, b_k[exact], b_r[exact])):
            raise AssertionError(f"fused_sgd_batched {what}: a row that does not clip differs "
                                 f"from the plain version")
        if clipped:  # the norm summed in another order than the plain version's
            atol, rtol = TOL_SGD_CLIP
            for k_, r_ in ((p_k, p_r), (b_k, b_r)):
                torch.testing.assert_close(k_[clipped], r_[clipped], atol=atol, rtol=rtol)
                worst = max(worst, float((k_[clipped] - r_[clipped]).abs().max()))
    say(f"  fused_sgd_batched n={n} G={G} ld={ld}, {' and '.join(routes)}: every row bit for "
        f"bit the one-client kernel's, two calls equal, the has-0 row and the pad untouched; "
        f"clipped rows {worst:.3e} from the plain version, the rest equal")
    return worst


def sgd_batched_phase(torch, fused_update, n_by_rate, lm_n_by_rate=None):
    """Kernel 3b held by :func:`sgd_batched_check` at ResNet-18's n at every
    level (``n_by_rate``) for G in ``SGD_BATCHED_G``, at the LM's level-a and
    level-e n (``lm_n_by_rate``) with G = 2 and at an odd n, each in the
    grouped engine's padded rows (and the odd n unpadded too); then timed at
    ``SGD_BATCHED_TIMED`` beside its bound, the launch floor of its plan (the
    empty kernel alone and with the plan's barrier) and ``torch._fused_sgd_``
    over the G rows (a yardstick, not the same function: no mask, no clip)
    -> results, ``by_level``."""
    from heterofl_tpu_torch.parallel.grouped import row_stride

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    kw = dict(momentum=0.9, weight_decay=5e-4, max_norm=1.0)
    lm_n_by_rate = lm_n_by_rate or {}
    shapes = [(n_by_rate[rate], G) for rate in LEVELS for G in SGD_BATCHED_G]
    shapes += [(n, 2) for n in lm_n_by_rate.values()]
    out = {"err": 0.0, "by_level": []}
    for n, G in shapes + [(SGD_ODD_N, 3)]:
        out["err"] = max(out["err"], sgd_batched_check(torch, fused_update, gen, n, G,
                                                       row_stride(n)))
        torch.cuda.empty_cache()
    for n, G in ((SGD_ODD_N, 3), (n_by_rate[0.0625], 4)):  # unpadded rows: scalar loads
        out["err"] = max(out["err"], sgd_batched_check(torch, fused_update, gen, n, G, n))
    say(f"fused_sgd_batched held at {len(shapes) + 3} shapes, both routes where a row has at "
        f"most {fused_update.SGD_CLUSTER_PARTS} parts: every row bit for bit the one-client "
        f"kernel's, two calls equal")
    timed = [("resnet18", rate, G, n_by_rate[rate]) for rate, G in SGD_BATCHED_TIMED]
    timed += [("transformer", 1.0, 2, lm_n_by_rate[1.0])] if 1.0 in lm_n_by_rate else []
    for model, rate, G, n in timed:
        ld = row_stride(n)
        g, p0, b0, mask, scal, _ = sgd_batched_inputs(torch, gen, n, G, ld)
        scal[:, 2] = 1.0
        p_t, b_t = padded_copy(torch, p0, ld)[1], padded_copy(torch, b0, ld)[1]
        plan = fused_update.sgd_plan_batched(n, G, ld)
        nbytes = 4 * ((5 * G + 1) * n + 3 * G)  # read g, p, buf, mask, scal; write p, buf
        r = {"model": model, "G": G, "rate": rate, "n": n, "ld": ld, "route": plan.route,
             "parts": plan.parts, "rows": plan.rows, "vec": plan.vec, "bytes": nbytes,
             "ops": 10 * G * n, "bound_ms": max(nbytes / BW, 10 * G * n / F32) * 1e3}
        for route in ("persistent", "cluster"):
            if route == "cluster" and plan.parts > fused_update.SGD_CLUSTER_PARTS:
                continue
            pl = fused_update.sgd_plan_batched(n, G, ld, route=route)

            def kern(pl=pl):
                fused_update.fused_sgd_batched_cuda(g, p_t, b_t, mask, scal, plan=pl, **kw)
            key = "" if route == plan.route else f"{route}_"
            r[f"{key}kernels_per_call"], names = kernels_per_call(kern)
            r[f"{key}kernel_names"] = names
            if r[f"{key}kernels_per_call"] != 1:
                raise AssertionError(f"fused_sgd_batched {model} n={n} G={G} {route}: "
                                     f"{r[key + 'kernels_per_call']} kernels a call ({names})")
            r[f"{key}ms"] = time_ms(kern, reps=5, samples=15)
            r[f"{key}device_ms"] = graph_ms(kern, calls=10, samples=11)
            floor, r[f"{key}grid"] = sgd_floor_call(torch, fused_update, pl, n, G)
            r[f"{key}floor_ms"] = graph_ms(floor, calls=10, samples=11)
            r[f"{key}floor_sync_ms"] = graph_ms(sgd_floor_call(
                torch, fused_update, pl, n, G, True)[0], calls=10, samples=11)
        r["plain_ms"] = time_ms(lambda: fused_update.fused_sgd_batched_plain(
            g, p0, b0, mask, scal, **kw), reps=2, samples=9)
        ps, gs, bs = list(p_t.unbind(0)), list(g.unbind(0)), list(b_t.unbind(0))

        def yard():
            torch._fused_sgd_(ps, gs, bs, weight_decay=5e-4, momentum=0.9, lr=0.1,
                              dampening=0.0, nesterov=False, maximize=False, is_first_step=False)
        r["yardstick_ms"] = time_ms(yard, reps=5, samples=15)
        r["yardstick_device_ms"] = graph_ms(yard, calls=10, samples=11)
        alt = "cluster" if plan.route == "persistent" else "persistent"
        other = (f"; {alt} route device {r[alt + '_device_ms']:.4f} ms (floor "
                 f"{r[alt + '_floor_ms']:.4f}, with its barrier {r[alt + '_floor_sync_ms']:.4f})"
                 if f"{alt}_device_ms" in r else "")
        say(f"  fused_sgd_batched {model} n={n} G={G} ({plan.route}, {plan.parts} parts, "
            f"rows {plan.rows}, vec {plan.vec}{', grid ' + str(r['grid']) if 'grid' in r else ''}"
            f"): {r['kernels_per_call']} kernel(s) a call in a profiler trace "
            f"({', '.join(r['kernel_names'])}), call {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB), "
            f"launch floor {r['floor_ms']:.4f} ms (with its barrier {r['floor_sync_ms']:.4f}){other}; "
            f"library: none; yardstick, not the same function: torch._fused_sgd_ over the "
            f"{G} rows (no mask, no clip) call {r['yardstick_ms']:.4f} ms, device "
            f"{r['yardstick_device_ms']:.4f} ms")
        out["by_level"].append(r)
        del g, p0, b0, p_t, b_t, ps, gs, bs
        torch.cuda.empty_cache()
    out.update({k: v for k, v in out["by_level"][0].items()
                if k in ("ms", "device_ms", "plain_ms", "bound_ms", "bytes", "ops")})
    out["kernels_per_call"] = max(v for r in out["by_level"] for k, v in r.items()
                                  if k.endswith("kernels_per_call"))
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
    return launches, flat_params(result["params"])



# -- the superstep ----------------------------------------------------------------


def graph_check_phase(torch, tmp: str, local_epochs: int, *flags, reps: int = 6,
                      what: str = "graph") -> dict:
    """The superstep's captured steps on the headline experiment at full
    width, directly on its masked engine and on a grouped engine of the same
    model: (a) a replayed draw -- the augmentation draws of a step captured
    with the engine's step generator registered -- gives fresh numbers at
    each replay, equal to the eager draws from the same seed bit for bit;
    (b) a level-a client's local epoch timed eagerly (``local_train``) and
    replayed from its captured step (``RoundEngine.client_step``) in turns,
    and the two equal bit for bit under cuDNN's deterministic algorithms;
    (c) a ``torch.profiler`` trace of a replayed epoch: kernels a step under
    replay, the device's busy share, and the hand-written kernels counted
    by name, which must equal the step's captured launches times the
    replays (a trace that lost records is taken again,
    :func:`traced_as_captured`); (d) the same count for a grouped (level a,
    G 2) epoch replayed from its captured batched step -> the numbers.  ``flags`` go to the
    experiment (``--compute_dtype bfloat16``), ``reps`` epochs of each kind
    are timed, ``what`` names the check in what it prints.  The kernels'
    wrappers take float32 operands only (``_build.require_cuda`` raises on
    any other), so every launch counted took float32 inputs."""
    from heterofl_tpu_torch.entry.common import FedExperiment, parse_cfg
    from heterofl_tpu_torch.fed.core import round_seed
    from heterofl_tpu_torch.ops.augment import augment_draws
    from heterofl_tpu_torch.parallel import GroupedRoundEngine, client_seed
    from heterofl_tpu_torch.parallel.step_graph import StepGraphs

    dev = torch.device("cuda")
    cfg = parse_cfg("graph checks", "resnet18", "CIFAR10", fed_argv(
        os.path.join(tmp, what), "dense", local_epochs, SS_ROUNDS, "--superstep_rounds",
        str(SS_ROUNDS), *flags))
    exp = FedExperiment(cfg, cfg["init_seed"])
    exp.stage(*exp.make_splits())
    eng, data = exp.engine, exp.train_data
    P = eng.flatten(exp.model.params())
    # (a) replayed draws
    gen = torch.Generator(device=dev)
    offs = torch.zeros((BATCH, 2), dtype=torch.int64, device=dev)
    flips = torch.zeros(BATCH, dtype=torch.bool, device=dev)

    def draw():
        o, f = augment_draws(BATCH, gen, dev)
        offs.copy_(o)
        flips.copy_(f)

    step = StepGraphs(dev).get("draws", draw, lambda: None, [gen])
    gen.manual_seed(1234)
    replays = []
    for _ in range(3):
        step.replay()
        replays.append((offs.clone(), flips.clone()))
    gen.manual_seed(1234)
    eager = [augment_draws(BATCH, gen, dev) for _ in range(3)]
    fresh = not torch.equal(replays[0][0], replays[1][0]) and not torch.equal(
        replays[1][0], replays[2][0])
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(replays, eager))
    say(f"graph draws: three replays of a captured augmentation draw differ from each other: "
        f"{fresh}; equal to three eager draws from the same seed bit for bit: {same}")
    if not (fresh and same):
        raise AssertionError("a replayed step does not draw fresh numbers equal to eager's")
    # (b) a level-a client's epoch: eager against replayed, in turns
    uid = 0  # users 0-19 are at level a
    cseed = client_seed(round_seed(0, 1), uid)
    lr = torch.full((), 0.1, dtype=torch.float32, device=dev)
    steps = -(-data[0].shape[1] // BATCH) * local_epochs
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def eager_epoch():
            g = torch.Generator(device=dev).manual_seed(cseed)
            return eng.local_train(P, 1.0, data[0][uid], data[1][uid], data[2][uid],
                                   data[3][uid], g, lr)

        def replayed_epoch():
            step, st = eng.client_step(1.0, P, data)
            eng.stage_client(st, P, 1.0, uid, data, cseed)
            st["lr"].copy_(lr)
            for _ in range(st["steps"]):
                step.replay()
            return st["p"], st["acc"]

        p_e, acc_e = eager_epoch()
        p_r, acc_r = replayed_epoch()
        bits = torch.equal(p_e, p_r) and torch.equal(acc_e, acc_r)
        times = {"eager": [], "replayed": []}
        for rep in range(reps):
            for kind in (("eager", "replayed") if rep % 2 == 0 else ("replayed", "eager")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (eager_epoch if kind == "eager" else replayed_epoch)()
                torch.cuda.synchronize()
                times[kind].append((time.perf_counter() - t0) * 1e3 / steps)
        want = {"masked": {k: v * steps for c in eng.client_step(1.0, P, data)[0].launches
                           for k, v in c.items()}}
        torch.cuda.synchronize()
        prof, masked, wall = traced_as_captured(replayed_epoch, want["masked"],
                                                f"{what} masked")
        traced = {"masked": masked}
        # (d) a grouped engine of the same model: two level-a clients' epoch
        # replayed from the captured batched step of (level a, G 2)
        geng = GroupedRoundEngine(exp.model, dict(exp.cfg, strategy="grouped"), dev)
        lv, users = geng.levels[1.0], [0, 1]
        gstep, gst, gens = geng.level_step(lv, len(users), P, data)
        geng.stage_level(lv, gst, gens, P, torch.tensor(users, device=dev), users, data,
                         round_seed(0, 1))
        geng._lr.copy_(lr)
        want["grouped"] = {k: v * gst["steps"] for c in gstep.launches for k, v in c.items()}
        torch.cuda.synchronize()

        def replayed_level():
            for _ in range(gst["steps"]):
                gstep.replay()
        traced["grouped"] = traced_as_captured(replayed_level, want["grouped"],
                                               f"{what} grouped")[1]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    kernels, busy = 0, 0.0
    for evt in prof.key_averages():
        if PAD_KERNEL in evt.key:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and evt.device_type is not None and "CUDA" in str(evt.device_type):
            kernels += evt.count
            busy += dev_us / 1e3
    ms = {k: statistics.median(v) for k, v in times.items()}
    out = {"eager_ms": ms["eager"], "replayed_ms": ms["replayed"], "steps": steps,
           "kernels_per_step": kernels / steps, "busy_share": busy / wall if wall else 0.0,
           "bits": bits, "traced": traced, "captured_x_replays": want}
    say(f"{what} step (level a, {steps} steps, host clock a step, median of {reps} in turns): eager "
        f"{ms['eager']:.3f} ms, replayed {ms['replayed']:.3f} ms "
        f"({ms['eager'] / ms['replayed']:.2f}x); replayed equals eager bit for bit under cuDNN's "
        f"deterministic algorithms: {bits}; a replayed epoch in a torch.profiler trace: "
        f"{kernels / steps:.1f} kernels a step, device busy {busy:.1f} of {wall:.1f} ms "
        f"({100 * out['busy_share']:.1f}%)")
    for eng_kind in ("masked", "grouped"):
        say(f"{what} launches ({eng_kind} level-a epoch replayed): hand-written kernels counted "
            f"by name in the trace {traced[eng_kind]}; the step's captured launches x replays "
            f"{want[eng_kind]}")
    if not bits or kernels == 0:
        raise AssertionError(f"{what}: the replayed epoch differs from the eager one, or the "
                             f"trace holds no kernel")
    del exp, eng, geng, data, P
    torch.cuda.empty_cache()
    return out


def superstep_path(torch, counters, out_dir: str, local_epochs: int, *flags,
                   what: str = "superstep path"):
    """``train_classifier_fed`` on the headline control at full width, two
    rounds evaluated after the second: first eagerly (``superstep_rounds``
    1), then as one superstep (``--superstep_rounds 2``: each client's
    steps replayed from the captured step of its level, the evaluation's
    forwards from one captured batch a shape, one metric fetch), both under
    cuDNN's deterministic algorithms (the masked engine's default
    algorithms sum convolution gradients in an order that changes run to
    run).  The superstep's cohorts, params, per-round metrics and fused
    Local and Global metrics must equal the eager run's bit for bit, and
    its batch-norm and fused-SGD launches come from replays, one step's
    captured launches a replay -> (launches, replayed launches, numbers).
    ``flags`` go to both runs (``--compute_dtype bfloat16``: the bf16
    headline), ``what`` names the path in what it prints."""
    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.parallel import step_graph

    steps = local_epochs * (SIZES["train"] // 100 // BATCH)
    extra = ("--eval_interval", str(SS_ROUNDS), *flags)
    runs, launches, secs = {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for run, more in (("eager", ()), ("superstep", ("--superstep_rounds", str(SS_ROUNDS)))):
            argv = fed_argv(os.path.join(out_dir, run), "dense", local_epochs, SS_ROUNDS,
                            *extra, *more)
            say(f"{what} ({run}): train_classifier_fed {' '.join(argv)}")
            step_graph.reset_stats()
            zero(counters)
            t0 = time.time()
            (runs[run],) = train_classifier_fed.main(argv)
            torch.cuda.synchronize()
            secs[run] = time.time() - t0
            launches[run] = read(counters)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    replayed, stats = dict(step_graph.REPLAYED), dict(step_graph.STATS)
    eager, ss = runs["eager"]["history"], runs["superstep"]["history"]
    total = 10 * steps * SS_ROUNDS  # 10 clients a round
    for r_e, r_s in zip(eager, ss):
        say(f"  round {r_e['epoch']}: eager {r_e['seconds']:.3f} s (host clock, "
            f"{1e3 * r_e['seconds'] / (10 * steps):.2f} ms a step), superstep "
            f"{r_s['seconds']:.3f} s (device clock between the round's marks, "
            f"{1e3 * r_s['seconds'] / (10 * steps):.2f} ms a step); loss {r_e['loss']:.6f} / "
            f"{r_s['loss']:.6f}")
    names = ("Local-Loss", "Local-Accuracy", "Global-Loss", "Global-Accuracy")
    say(f"  evaluation after round {SS_ROUNDS}: eager {eager[-1]['eval_seconds']:.2f} s (host "
        f"clock), fused {ss[-1]['eval_seconds']:.2f} s (device clock); "
        + ", ".join(f"{k} {eager[-1][k]:.6f} / {ss[-1][k]:.6f}" for k in names))
    say(f"{what} (host clock, the whole run with staging, evaluation and checkpoints): "
        f"eager run {secs['eager']:.3f} s, superstep run {secs['superstep']:.3f} s; "
        f"{stats['captures']} captures in "
        f"{stats['capture_seconds']:.2f} s (warm-up included), {stats['replays']} replays, "
        f"graph pools {stats['pool_bytes'] / 1e6:.1f} MB; launches {launches['superstep']}, "
        f"from replays {replayed} (the captured count times the replays): "
        f"{replayed.get('bn_fwd', 0) / total:.1f} bn_fwd, {replayed.get('bn_bwd', 0) / total:.1f} "
        f"bn_bwd, {replayed.get('fused_sgd', 0) / total:.1f} fused_sgd calls a step under replay")
    same_users = [r["users"] for r in eager] == [r["users"] for r in ss]
    bits = all(torch.equal(runs["superstep"]["params"][k], v)
               for k, v in runs["eager"]["params"].items())
    same_metrics = all(a[k] == b[k] for a, b in zip(eager, ss) for k in ("loss", "accuracy", "n")) \
        and all(eager[-1][k] == ss[-1][k] for k in names)
    say(f"{what} against eager: the same cohorts {same_users}; params equal bit for bit "
        f"{bits}; round and fused-evaluation metrics equal {same_metrics}")
    want = {"bn_fwd": BN_SITES * total, "bn_bwd": BN_SITES * total, "fused_sgd": total}
    if not (same_users and bits and same_metrics and len(ss) == SS_ROUNDS) or any(
            replayed.get(k) != v or launches["superstep"][k] < v for k, v in want.items()):
        raise AssertionError(f"{what}: it does not equal the eager run, or its replayed "
                             f"launches {replayed} are not {want}")
    numbers = {"eager_run_s": secs["eager"], "superstep_run_s": secs["superstep"],
               "eager_round_s": [r["seconds"] for r in eager],
               "superstep_round_s": [r["seconds"] for r in ss],
               "eager_eval_s": eager[-1]["eval_seconds"], "fused_eval_s": ss[-1]["eval_seconds"],
               "captures": stats["captures"], "capture_s": stats["capture_seconds"],
               "pool_mb": stats["pool_bytes"] / 1e6, "finite": all(
                   math.isfinite(r[k]) for r in ss for k in ("loss", "accuracy")) and all(
                   math.isfinite(ss[-1][k]) for k in names)}
    if not numbers["finite"]:
        raise AssertionError(f"{what}: a logged value is not finite: {ss}")
    return launches["superstep"], replayed, numbers


def grouped_superstep_path(torch, counters, out_dir: str, local_epochs: int):
    """``train_classifier_fed --strategy grouped --wire_codec int8
    --superstep_rounds 2`` on the headline control at full width (the
    control's own cohorts, the levels' G as they fall): three rounds, a
    superstep of two and the clamped tail of one, evaluated after the last;
    then two rounds and round 3 resumed from their checkpoint at the
    superstep boundary, which must equal the uninterrupted run bit for bit
    -- params and the int8 residual -- and draw its cohort (the codec's grid
    is sized for a superstep's slots, so a run resumes only at a superstep
    boundary).  The batched kernels run from replays, one quantise-and-pack
    a round, no one-client kernel -> (launches, launches of the resumed
    round, launches from replays)."""
    import numpy as np

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.parallel import step_graph

    rounds = SS_ROUNDS + 1
    extra = ("--strategy", "grouped", "--superstep_rounds", str(SS_ROUNDS), "--eval_interval",
             str(rounds))
    argv = fed_argv(os.path.join(out_dir, "full"), "int8", local_epochs, rounds, *extra)
    say(f"grouped superstep path: train_classifier_fed {' '.join(argv)}")
    step_graph.reset_stats()
    zero(counters)
    t0 = time.time()
    (full,) = train_classifier_fed.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches, replayed = read(counters), dict(step_graph.REPLAYED)
    stats = dict(step_graph.STATS)
    for r in full["history"]:
        say(f"  round {r['epoch']}: rates {sorted(r['user_rates'])}; loss {r['loss']:.4f} in "
            f"{r['seconds']:.3f} s (device clock)")
    last = full["history"][-1]
    say(f"grouped superstep path: {secs:.1f} s host clock, the whole run; {stats['captures']} "
        f"captures in {stats['capture_seconds']:.2f} s, graph pools "
        f"{stats['pool_bytes'] / 1e6:.1f} MB; launches {launches}, from replays {replayed}; "
        f"fused evaluation after round {rounds}: Global loss {last['Global-Loss']:.4f} "
        f"accuracy {last['Global-Accuracy']:.2f}% in {last['eval_seconds']:.2f} s")
    cut = os.path.join(out_dir, "cut")
    train_classifier_fed.main(fed_argv(cut, "int8", local_epochs, SS_ROUNDS, *extra))
    zero(counters)
    (res,) = train_classifier_fed.main(fed_argv(cut, "int8", local_epochs, rounds, *extra,
                                                "--resume_mode", "1"))
    torch.cuda.synchronize()
    resumed = read(counters)
    (rec,) = res["history"]
    bits = all(torch.equal(res["params"][k], v) for k, v in full["params"].items())
    resid = np.array_equal(res["wire_resid"], full["wire_resid"])
    say(f"grouped superstep resumed round: trained round {rec['epoch']} (users {rec['users']}, "
        f"the uninterrupted run's {full['history'][-1]['users']}); params equal bit for bit "
        f"{bits}, int8 residual equal {resid}; launches {resumed}")
    one_client = sum(launches[k] for k in ("bn_fwd", "bn_bwd", "fused_sgd"))
    if not (bits and resid and rec["epoch"] == rounds
            and rec["users"] == full["history"][-1]["users"]) or one_client \
            or launches["quant_pack"] != rounds or resumed["quant_pack"] != 1 or not all(
                replayed.get(k, 0) > 0 for k in NO_BATCHED) or not all(
                math.isfinite(r["loss"]) for r in full["history"]):
        raise AssertionError("grouped superstep path: it does not resume bit for bit, or its "
                             f"launches {launches} / {replayed} are not the batched kernels'")
    return launches, resumed, replayed


def lm_superstep_path(torch, counters, out_dir: str, lm_dir: str):
    """``train_transformer_fed --superstep_rounds 2`` on the LM control at
    full width: two rounds of ``LM_STEPS`` steps as one superstep, each
    evaluated by the fused Global pass (a captured window forward, its
    corruption drawn from the evaluation's registered generator), against
    the LM main path's eager rounds 1 and 2 (its round-2 checkpoint
    generation and its log) -> (launches, launches from replays)."""
    from heterofl_tpu_torch.convert import params_to_jax
    from heterofl_tpu_torch.entry import train_transformer_fed
    from heterofl_tpu_torch.parallel import step_graph
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint
    from heterofl_tpu_torch.utils.checkpoint import generation_paths

    argv = lm_argv(out_dir, SS_ROUNDS, "--superstep_rounds", str(SS_ROUNDS))
    say(f"LM superstep path: train_transformer_fed {' '.join(argv)}")
    step_graph.reset_stats()
    zero(counters)
    t0 = time.time()
    (result,) = train_transformer_fed.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches, replayed = read(counters), dict(step_graph.REPLAYED)
    hist = result["history"]
    (eager,) = [b for b in map(load_checkpoint, generation_paths(checkpoint_path(lm_dir, LM_TAG)))
                if b["epoch"] == SS_ROUNDS + 1]
    mine = params_to_jax({k: v.detach() for k, v in result["params"].items()},
                         make_lm_perms(torch))
    diff = max(float(abs(mine[k].astype("float64") - eager["params"][k]).max()) for k in mine)
    bits = all((mine[k] == eager["params"][k]).all() for k in mine)
    logged = eager["logger_history"]["test/Global-Perplexity"][:SS_ROUNDS]
    for r, ppl in zip(hist, logged):
        say(f"  round {r['epoch']}: loss {r['loss']:.4f} in {r['seconds']:.3f} s (device clock, "
            f"{1e3 * r['seconds'] / LM_STEPS:.2f} ms a step); fused Global perplexity "
            f"{r['Global-Perplexity']:.4f} (eager {ppl:.4f}) in {r['eval_seconds']:.3f} s")
    say(f"LM superstep path: {secs:.1f} s; launches {launches}, from replays {replayed}; "
        f"against the eager rounds: max |params diff| {diff:.3e}, bit for bit {bits} "
        f"(tolerance {TOL_LM_ROUND:g})")
    if not (diff <= TOL_LM_ROUND and replayed.get("fused_sgd") == SS_ROUNDS * LM_STEPS
            and launches["bn_fwd"] == 0 and len(hist) == SS_ROUNDS) or not all(
            math.isfinite(r[k]) for r in hist for k in ("loss", "Global-Perplexity")):
        raise AssertionError(f"LM superstep path: launches {launches} / {replayed}, diff {diff}")
    mask_row_kept(torch, result["params"])
    return launches, replayed


def bf16_accumulate_check(torch) -> dict:
    """Whether the card's bf16 products accumulate in float32, as
    ``compute_dtype='bfloat16'`` assumes (the reference's "XLA:TPU
    accumulates bf16 convs in f32"): cuDNN's convolution under its
    deterministic algorithms (ResNet-18's widest 3x3 site, a 4,608-term
    sum, channels_last, and its 1x1 shortcut), the im2col path's batched
    matmul and a linear layer (cuBLAS, reduced-precision reduction pinned
    off by the package), each against the float32 op on the same
    bf16-rounded operands.  With float32 accumulation the only error is the
    output's one rounding to bf16, a relative L2 error of about 2^-9 (at
    most 2^-8); a bf16 accumulator adds a rounding at every partial sum
    -> each op's relative L2 error in units of 2^-8 (at most 1)."""
    import torch.nn.functional as F

    from heterofl_tpu_torch.ops import layers

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((10, 512, 4, 4), generator=gen, device="cuda").to(
        memory_format=torch.channels_last)
    w = torch.randn((512, 512, 3, 3), generator=gen, device="cuda") * 0.05
    w1 = torch.randn((512, 256, 1, 1), generator=gen, device="cuda") * 0.05
    a = torch.randn((4, 640, 2304), generator=gen, device="cuda")
    b = torch.randn((4, 2304, 256), generator=gen, device="cuda") * 0.05
    xb, wb, w1b, ab, bb = (t.to(torch.bfloat16) for t in (x, w, w1, a, b))
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cases = {
            "cudnn conv 3x3 (C 512)": (lambda: F.conv2d(xb, wb, padding=1),
                                       lambda: F.conv2d(xb.float(), wb.float(), padding=1)),
            "cudnn conv 1x1 stride 2 (C 256)": (
                lambda: F.conv2d(xb[:, :256], w1b, stride=2),
                lambda: F.conv2d(xb[:, :256].float(), w1b.float(), stride=2)),
            "im2col conv 3x3 (bmm)": (
                lambda: layers.conv2d(x, w, compute_dtype=torch.bfloat16, impl="im2col"),
                lambda: F.conv2d(xb.float(), wb.float(), padding=1)),
            "cublas bmm": (lambda: torch.bmm(ab, bb), lambda: torch.bmm(ab.float(), bb.float())),
            "cublas linear": (lambda: F.linear(ab[0], bb[0].t()),
                              lambda: F.linear(ab[0].float(), bb[0].float().t())),
        }
        for name, (low, ref) in cases.items():
            got, want = low().float(), ref()
            err = float((got - want).norm() / want.norm()) / 2.0 ** -8
            out[name] = err
            say(f"bf16 accumulation, {name}: relative L2 error {err:.3f} x 2^-8 against the "
                f"float32 op (float32 accumulation keeps it at most 1)")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if max(out.values()) > 1.0:
        raise AssertionError(f"bf16 products are not accumulated in float32: {out}")
    return out


def lm_bf16_path(torch, counters, out_dir: str):
    """``train_transformer_fed --compute_dtype bfloat16`` on the LM control
    at full width: two rounds eagerly, then as one superstep; the rounds'
    logged values finite and the superstep equal to the eager rounds bit
    for bit (params, round losses), its fused-SGD launches from replays
    -> (launches, launches from replays, numbers)."""
    from heterofl_tpu_torch.entry import train_transformer_fed
    from heterofl_tpu_torch.parallel import step_graph

    runs, launches, secs = {}, {}, {}
    for run, more in (("eager", ()), ("superstep", ("--superstep_rounds", str(SS_ROUNDS)))):
        argv = lm_argv(os.path.join(out_dir, run), SS_ROUNDS, "--compute_dtype", "bfloat16",
                       *more)
        say(f"bf16 LM ({run}): train_transformer_fed {' '.join(argv)}")
        step_graph.reset_stats()
        zero(counters)
        t0 = time.time()
        (runs[run],) = train_transformer_fed.main(argv)
        torch.cuda.synchronize()
        secs[run] = time.time() - t0
        launches[run] = read(counters)
    replayed = dict(step_graph.REPLAYED)
    eager, ss = runs["eager"]["history"], runs["superstep"]["history"]
    for r_e, r_s in zip(eager, ss):
        say(f"  round {r_e['epoch']}: eager {r_e['seconds']:.3f} s (host clock), superstep "
            f"{r_s['seconds']:.3f} s (device clock); loss {r_e['loss']:.6f} / {r_s['loss']:.6f}; "
            f"Global perplexity {r_e['Global-Perplexity']:.4f} / {r_s['Global-Perplexity']:.4f}")
    bits = all(torch.equal(runs["superstep"]["params"][k], v)
               for k, v in runs["eager"]["params"].items())
    same = [r["loss"] for r in eager] == [r["loss"] for r in ss]
    finite = all(math.isfinite(r[k]) for r in eager + ss for k in ("loss", "Global-Perplexity"))
    say(f"bf16 LM: runs {secs['eager']:.1f} s eager, {secs['superstep']:.1f} s superstep (host "
        f"clock); superstep equals the eager rounds bit for bit {bits}, round losses equal "
        f"{same}, finite {finite}; launches {launches['superstep']}, from replays {replayed}")
    if not (bits and same and finite and len(ss) == SS_ROUNDS
            and replayed.get("fused_sgd") == SS_ROUNDS * LM_STEPS
            and launches["superstep"]["bn_fwd"] == 0):
        raise AssertionError(f"bf16 LM: the superstep does not equal the eager rounds, or its "
                             f"launches {launches['superstep']} / {replayed} are wrong")
    mask_row_kept(torch, runs["superstep"]["params"])
    return launches["superstep"], replayed, {
        "eager_run_s": secs["eager"], "superstep_run_s": secs["superstep"],
        "eager_round_s": [r["seconds"] for r in eager],
        "superstep_round_s": [r["seconds"] for r in ss]}


def im2col_path(torch, counters, out_dir: str, local_epochs: int):
    """One round of the headline control at full width on ``IM2COL_SIZES``
    (two steps a client), masked and ``--strategy grouped``, on a pinned
    cohort of two clients a level (G 2 at every level), with ``--conv_impl
    im2col`` and with the direct convolution from the same seed: the im2col
    round's params within ``TOL_IM2COL`` of the direct round's (the same
    math, another summation order), finite, the batch-norm and SGD kernels
    launched (the one-client ones masked, the batched ones grouped) ->
    launches per path."""
    import numpy as np

    from heterofl_tpu_torch.entry import common, train_classifier_fed

    cohort = np.array([20 * lvl + i for lvl in range(5) for i in (0, 1)], np.int64)
    sample_users = common.FedExperiment.sample_users
    common.FedExperiment.sample_users = lambda self, epoch: cohort
    out = {}
    try:
        for strategy in ("masked", "grouped"):
            params = {}
            for impl in ("direct", "im2col"):
                argv = fed_argv(os.path.join(out_dir, f"{strategy}_{impl}"), "dense",
                                local_epochs, 1, "--strategy", strategy, "--conv_impl", impl,
                                "--synthetic_sizes", json.dumps(IM2COL_SIZES))
                say(f"im2col path ({strategy}, {impl}): train_classifier_fed {' '.join(argv)}")
                zero(counters)
                t0 = time.time()
                (result,) = train_classifier_fed.main(argv)
                torch.cuda.synchronize()
                launches = read(counters)
                (rec,) = result["history"]
                say(f"  {time.time() - t0:.1f} s; loss {rec['loss']:.6f}, Global accuracy "
                    f"{rec['Global-Accuracy']:.2f}%; launches {launches}")
                params[impl] = result["params"]
                kernels = ("bn_fwd", "bn_bwd", "fused_sgd") if strategy == "masked" else \
                    tuple(NO_BATCHED)
                if not all(launches[k] > 0 for k in kernels) or not all(
                        math.isfinite(rec[k]) for k in ("loss", "Global-Loss")):
                    raise AssertionError(f"im2col path ({strategy}, {impl}): launches "
                                         f"{launches}, history {rec}")
                out[f"im2col_{strategy}" if impl == "im2col" else f"direct_{strategy}"] = launches
            diff = max(float((params["im2col"][k] - v).abs().max())
                       for k, v in params["direct"].items())
            finite = all(bool(torch.isfinite(v).all()) for v in params["im2col"].values())
            say(f"im2col path ({strategy}): params after the round, im2col against direct: max "
                f"|diff| {diff:.3e} (tolerance {TOL_IM2COL:g}); finite {finite}")
            if not (diff <= TOL_IM2COL and finite):
                raise AssertionError(f"im2col path ({strategy}): im2col is {diff:.3e} from direct")
    finally:
        common.FedExperiment.sample_users = sample_users
    return out


def codec_map_path(torch, counters, out_dir: str, local_epochs: int, quant, codecs):
    """``train_classifier_fed --strategy grouped --superstep_rounds 2`` with
    the per-level wire-codec map ``CODEC_MAP`` on the headline control at
    full width (its own cohorts): three rounds, a superstep and its tail;
    then two rounds and round 3 resumed at the superstep boundary, equal to
    the uninterrupted run bit for bit, params and the concatenated
    residual ``[2, total_lossy]``.  Every lossy level encodes every round,
    so the quantise-and-pack kernel runs once an int8 level a round.  Then
    that kernel held against its plain version (and timed) at level b's and
    level c's sliced n -> (launches, launches of the resumed round, launches
    from replays, the kernel's numbers by level)."""
    import numpy as np

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.entry.common import parse_cfg
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.ops.fused_update import FlatSpec
    from heterofl_tpu_torch.parallel import step_graph

    rounds = SS_ROUNDS + 1
    codec = json.dumps(CODEC_MAP)
    int8_levels = [float(r) for r, c in CODEC_MAP.items() if c == "int8"]
    extra = ("--strategy", "grouped", "--superstep_rounds", str(SS_ROUNDS), "--eval_interval",
             str(rounds))
    argv = fed_argv(os.path.join(out_dir, "full"), codec, local_epochs, rounds, *extra)
    say(f"per-level map path: train_classifier_fed {' '.join(argv)}")
    step_graph.reset_stats()
    zero(counters)
    t0 = time.time()
    (full,) = train_classifier_fed.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches, replayed = read(counters), dict(step_graph.REPLAYED)
    for r in full["history"]:
        say(f"  round {r['epoch']}: rates {sorted(r['user_rates'])}; loss {r['loss']:.4f} in "
            f"{r['seconds']:.3f} s (device clock)")
    cut = os.path.join(out_dir, "cut")
    train_classifier_fed.main(fed_argv(cut, codec, local_epochs, SS_ROUNDS, *extra))
    zero(counters)
    (res,) = train_classifier_fed.main(fed_argv(cut, codec, local_epochs, rounds, *extra,
                                                "--resume_mode", "1"))
    torch.cuda.synchronize()
    resumed = read(counters)
    (rec,) = res["history"]
    cfg = parse_cfg("per-level map", "resnet18", "CIFAR10", argv)
    cfg["classes_size"] = 10
    level_specs = {rate: FlatSpec.of(dict(make_model(cfg, rate).named_parameters()))
                   for rate in LEVELS}
    total_lossy = sum(level_specs[float(r)].total for r, c in CODEC_MAP.items() if c != "dense")
    bits = all(torch.equal(res["params"][k], v) for k, v in full["params"].items())
    resid = np.array_equal(res["wire_resid"], full["wire_resid"])
    shape = tuple(full["wire_resid"].shape)
    say(f"per-level map path: {secs:.1f} s host clock, the whole run; launches {launches}, from "
        f"replays {replayed}; resumed round {rec['epoch']} (users {rec['users']}, the "
        f"uninterrupted run's {full['history'][-1]['users']}): params equal bit for bit {bits}, "
        f"residual {shape} (want (2, {total_lossy})) equal {resid}; launches {resumed}")
    one_client = sum(launches[k] for k in ("bn_fwd", "bn_bwd", "fused_sgd"))
    if not (bits and resid and shape == (2, total_lossy) and rec["epoch"] == rounds
            and rec["users"] == full["history"][-1]["users"]) or one_client \
            or launches["quant_pack"] != rounds * len(int8_levels) \
            or resumed["quant_pack"] != len(int8_levels) or not all(
                replayed.get(k, 0) > 0 for k in NO_BATCHED) or not all(
                math.isfinite(r["loss"]) for r in full["history"]):
        raise AssertionError("per-level map path: it does not resume bit for bit, or its "
                             f"launches {launches} / {replayed} / {resumed} are wrong")
    by_level = {}
    for rate in int8_levels:
        spec = level_specs[rate]
        P = spec.flatten(dict(make_model(cfg, rate).init_(
            torch.Generator().manual_seed(0)).named_parameters())).cuda()
        say(f"quant_pack at level {rate:g}'s sliced n:")
        by_level[rate] = quant_phase(torch, quant, codecs, spec, P)
    return launches, resumed, replayed, by_level


def gate_kernel_phase(torch, fused_update, level_n) -> None:
    """The kernels under the scheduler's gates (phase 10a): the one-client
    fused SGD with ``has`` 0 at ResNet-18's n leaves ``p`` and ``buf`` bit
    for bit; kernel 3b at (level a, G 2) and (level e, G 4) with ``has``
    rows ``[1, 0, ...]`` (a deadline's or a padding slot's gated rows):
    the gated rows bit for bit untouched, the live row bit for bit the
    one-client kernel's on it."""
    from heterofl_tpu_torch.parallel.grouped import row_stride

    kw = dict(momentum=0.9, weight_decay=5e-4, max_norm=1.0)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    n = level_n[1.0]
    g, p, buf = (torch.randn(n, device=dev, generator=gen) for _ in range(3))
    mask = (torch.rand(n, device=dev, generator=gen) < 0.9).to(torch.float32)
    p0, b0 = p.clone(), buf.clone()
    fused_update.fused_sgd_cuda(g, p, buf, mask, torch.tensor([7.0, 0.1, 0.0], device=dev), **kw)
    torch.cuda.synchronize()
    if not (same_bits(torch, p, p0) and same_bits(torch, buf, b0)):
        raise AssertionError("fused_sgd with has 0 moved p or buf")
    say(f"  fused_sgd n={n} with has 0: p and buf bit for bit untouched")
    for rate, G in ((1.0, 2), (0.0625, 4)):
        n = level_n[rate]
        ld = row_stride(n)
        g, p0, b0, mask, scal, _ = sgd_batched_inputs(torch, gen, n, G, ld)
        scal[:, 2] = 0.0
        scal[0, 2] = 1.0
        (_, p_k), (_, b_k) = padded_copy(torch, p0, ld), padded_copy(torch, b0, ld)
        fused_update.fused_sgd_batched_cuda(g, p_k, b_k, mask, scal, **kw)
        pu, bu = p0[0].clone(), b0[0].clone()
        fused_update.fused_sgd_cuda(g[0].clone(), pu, bu, mask, scal[0].clone(), **kw)
        torch.cuda.synchronize()
        if not (same_bits(torch, p_k[1:], p0[1:]) and same_bits(torch, b_k[1:], b0[1:])):
            raise AssertionError(f"fused_sgd_batched level {rate:g} G {G}: a gated row moved")
        if not (same_bits(torch, p_k[0], pu) and same_bits(torch, b_k[0], bu)):
            raise AssertionError(f"fused_sgd_batched level {rate:g} G {G}: the live row differs "
                                 f"from the one-client kernel")
        say(f"  fused_sgd_batched level {rate:g} G {G} (n={n}), has rows [1, 0, ...]: the gated "
            f"rows bit for bit untouched, the live row bit for bit the one-client kernel's")


def scenario_argv(out_dir: str, rounds: int, schedule, *extra, codec: str = "dense"):
    """The headline control's flags with a schedule, on ``SCENARIO_SIZES``,
    one local epoch, evaluated after the last round only."""
    return ["--control_name", HEADLINE, "--synthetic", "1", "--synthetic_sizes",
            json.dumps(SCENARIO_SIZES), "--pallas_norm", "1", "--fused_update", "1",
            "--wire_codec", codec, "--eval_interval", str(SCENARIO_ROUNDS),
            "--output_dir", out_dir, "--schedule", json.dumps(schedule),
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1}}), *extra]


def scenario_steps(hist, total: int, rates, min_frac: float):
    """The local steps a scenario run's rounds took, from its logged cohorts
    and the port's own deadline draws (``deadline_steps`` at each round's
    seed, experiment seed 0): the masked engine steps each slot that
    trained (rate above 0) to its budget; the grouped engine steps each
    level to its largest budget (a level of padding only: 0) ->
    (masked steps, grouped level-steps, lockstep client-steps)."""
    import numpy as np

    from heterofl_tpu_torch.fed.core import round_seed
    from heterofl_tpu_torch.sched.deadline import deadline_steps

    masked = grouped = lockstep = 0
    for r in hist:
        users = np.asarray(r["users"], np.int64)
        trained = np.asarray(r["user_rates"]) > 0
        lim = np.where(trained, np.minimum(
            deadline_steps(round_seed(0, r["epoch"]), users, total, min_frac), total), 0)
        masked += int(lim.sum())
        levels = np.asarray(rates)[users]  # a -1 slot at the last user's level
        grouped += sum(int(lim[levels == lv].max()) for lv in set(levels.tolist()))
        lockstep += total * users.size
    return masked, grouped, lockstep


def say_slots(what: str, hist) -> None:
    for r in hist:
        say(f"  {what} round {r['epoch']}: users {r['users']}; {r['filled']} of "
            f"{len(r['users'])} slots filled, {r['failed']} failed; n {r['n']:.0f}; loss "
            f"{r['loss']:.6f}")


def scenario_masked_path(torch, counters, out_dir: str):
    """Phase 10b: ``train_classifier_fed`` on the headline control at full
    width with ``--schedule SCENARIO_MASKED --client_failure_rate
    SCENARIO_FAIL`` (markov availability, a deadline, buffered
    aggregation), three rounds eagerly and as ``--superstep_rounds 2``
    (two and the clamped tail), under cuDNN's deterministic algorithms:
    the same cohorts, params, staleness buffer and round metrics bit for
    bit; the steps each run took (its fused-SGD launches, eager; from
    replays, the superstep, with 17 BN launches a step) equal the budgets
    of the clients that trained; then two rounds and round 3 resumed from
    their checkpoint, whose ``sched_buf`` is non-zero, equal to the
    uninterrupted superstep run bit for bit -> (launches, replayed)."""
    import numpy as np

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.parallel import step_graph
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint

    extra = ("--client_failure_rate", str(SCENARIO_FAIL))
    ss = ("--superstep_rounds", str(SS_ROUNDS))
    runs, secs, launches, replayed = {}, {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for run, more in (("eager", ()), ("superstep", ss)):
            argv = scenario_argv(os.path.join(out_dir, run), SCENARIO_ROUNDS, SCENARIO_MASKED,
                                 *extra, *more)
            say(f"scenario masked ({run}): train_classifier_fed {' '.join(argv)}")
            step_graph.reset_stats()
            zero(counters)
            t0 = time.time()
            (runs[run],) = train_classifier_fed.main(argv)
            torch.cuda.synchronize()
            secs[run] = time.time() - t0
            launches[run], replayed[run] = read(counters), dict(step_graph.REPLAYED)
        cut = os.path.join(out_dir, "cut")
        train_classifier_fed.main(scenario_argv(cut, SS_ROUNDS, SCENARIO_MASKED, *extra, *ss))
        blob = load_checkpoint(checkpoint_path(cut, TAG))
        t0 = time.time()
        (res,) = train_classifier_fed.main(scenario_argv(cut, SCENARIO_ROUNDS, SCENARIO_MASKED,
                                                         *extra, *ss, "--resume_mode", "1"))
        torch.cuda.synchronize()
        secs["resumed"] = time.time() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    eager, sup = runs["eager"]["history"], runs["superstep"]["history"]
    say_slots("scenario masked", sup)
    total = SCENARIO_SIZES["train"] // 100 // BATCH
    steps, _, lockstep = scenario_steps(sup, total, np.repeat(LEVELS, 20), SCENARIO_MIN_FRAC)
    bits = all(torch.equal(runs["superstep"]["params"][k], v)
               for k, v in runs["eager"]["params"].items())
    buf = np.array_equal(runs["superstep"]["sched_buf"], runs["eager"]["sched_buf"])
    same = [r["users"] for r in eager] == [r["users"] for r in sup] and all(
        a[k] == b[k] for a, b in zip(eager, sup) for k in ("loss", "accuracy", "n"))
    resumed = all(torch.equal(res["params"][k], v) for k, v in runs["superstep"]["params"].items())
    resumed_buf = np.array_equal(res["sched_buf"], runs["superstep"]["sched_buf"])
    cut_buf = blob["sched_buf"]
    say(f"scenario masked: runs {secs['eager']:.1f} s eager, {secs['superstep']:.1f} s superstep, "
        f"{secs['resumed']:.1f} s the resumed round (host clock); steps {steps} of the lockstep "
        f"budget {lockstep} (eager fused_sgd launches {launches['eager']['fused_sgd']}, replayed "
        f"{replayed['superstep']}); superstep == eager: params bit for bit {bits}, staleness "
        f"buffer {buf}, cohorts and round metrics {same}; resumed from the boundary checkpoint "
        f"(sched_buf non-zero {bool(np.any(cut_buf != 0))}): params {resumed}, buffer "
        f"{resumed_buf}; launches {launches['superstep']}")
    want = {"bn_fwd": BN_SITES * steps, "bn_bwd": BN_SITES * steps, "fused_sgd": steps}
    if not (bits and buf and same and resumed and resumed_buf and np.any(cut_buf != 0)
            and [r["epoch"] for r in res["history"]] == [SCENARIO_ROUNDS]
            and res["history"][0]["users"] == sup[-1]["users"]
            and launches["eager"]["fused_sgd"] == steps < lockstep
            and all(replayed["superstep"].get(k) == v for k, v in want.items())
            and all(math.isfinite(r["loss"]) for r in sup)):
        raise AssertionError("scenario masked: the superstep, the eager run and the resumed run "
                             f"disagree, or the steps {replayed['superstep']} are not {want}")
    return launches["superstep"], replayed["superstep"]


def scenario_grouped_path(torch, counters, out_dir: str):
    """Phase 10c: ``train_classifier_fed --strategy grouped
    --superstep_rounds 2`` on the headline control at full width with a
    ``trace`` schedule of ``SCENARIO_TRACE_AVAIL`` users available in its
    three rounds (rounds 1 and 3 leave slots unfilled: ``-1`` slots at
    level e, their rows gated), a deadline and buffered aggregation: three
    rounds, then two and round 3 resumed at the superstep boundary, equal
    bit for bit (params and staleness buffer); kernel 3b's replays equal
    the levels' largest budgets, 1b/2b's 17 a step, no one-client kernel
    -> (launches, replayed)."""
    import numpy as np

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.parallel import step_graph

    rng = np.random.default_rng(12)
    trace = np.zeros((len(SCENARIO_TRACE_AVAIL), 100), np.uint8)
    for row, k in zip(trace, SCENARIO_TRACE_AVAIL):
        row[rng.choice(100, k, replace=False)] = 1
    sched = {"kind": "trace", "trace": trace.tolist(),
             "deadline": {"min_frac": SCENARIO_MIN_FRAC}, "aggregation": "buffered"}
    extra = ("--strategy", "grouped", "--superstep_rounds", str(SS_ROUNDS))
    argv = scenario_argv(os.path.join(out_dir, "full"), SCENARIO_ROUNDS, sched, *extra)
    say(f"scenario grouped: train_classifier_fed {' '.join(argv[:-4])} ... (the trace)")
    step_graph.reset_stats()
    zero(counters)
    t0 = time.time()
    (full,) = train_classifier_fed.main(argv)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches, replayed = read(counters), dict(step_graph.REPLAYED)
    hist = full["history"]
    say_slots("scenario grouped", hist)
    cut = os.path.join(out_dir, "cut")
    train_classifier_fed.main(scenario_argv(cut, SS_ROUNDS, sched, *extra))
    (res,) = train_classifier_fed.main(scenario_argv(cut, SCENARIO_ROUNDS, sched, *extra,
                                                     "--resume_mode", "1"))
    total = SCENARIO_SIZES["train"] // 100 // BATCH
    _, steps, lockstep = scenario_steps(hist, total, np.repeat(LEVELS, 20), SCENARIO_MIN_FRAC)
    bits = all(torch.equal(res["params"][k], v) for k, v in full["params"].items())
    buf = np.array_equal(res["sched_buf"], full["sched_buf"])
    unfilled = [r["epoch"] for r in hist if -1 in r["users"]]
    say(f"scenario grouped: {secs:.1f} s the run (host clock); level-steps {steps} (client-steps "
        f"of the lockstep budget {lockstep}); rounds with unfilled slots {unfilled}; resumed at "
        f"the boundary: params bit for bit {bits}, staleness buffer {buf}; launches {launches}, "
        f"from replays {replayed}")
    one_client = sum(launches[k] for k in ("bn_fwd", "bn_bwd", "fused_sgd"))
    if not (bits and buf and unfilled == [1, 3] and not one_client
            and replayed.get("fused_sgd_batched") == steps
            and replayed.get("bn_fwd_batched") == BN_SITES * steps
            and res["history"][0]["users"] == hist[-1]["users"]
            and np.any(full["sched_buf"] != 0)
            and all(math.isfinite(r["loss"]) for r in hist)):
        raise AssertionError(f"scenario grouped: the resumed run differs, or the launches "
                             f"{launches} / {replayed} do not match the budgets ({steps})")
    return launches, replayed


def scenario_grouped_int8_phase(torch, devices=("cuda", "cpu"), stream: bool = False) -> None:
    """Phase 10c: one grouped int8 round (the superstep of one round) with
    unfilled slots on the card (kernels) against the same round on the CPU
    (plain versions): the conv net (16/32, MNIST), levels a, b and e, two
    ``-1`` slots at level e (the last user's), epoch permutations and codec
    noise injected; the grid sized for 4 levels x 4 slots; params within
    ``TOL_ROUND`` but a share ``SHARE_ROUND_INT8`` within one grid step,
    the residual within ``5 x TOL_ROUND`` but that share within one step.
    ``stream`` (phase 11b): the K=1 round of ``client_store='stream'``,
    which the eager store refuses, its cohort staged from a ``ClientStore``
    (``stage_cohort``, ``train_superstep(cohort=...)``) on both devices."""
    import numpy as np

    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.data import (fetch_dataset, label_split_masks, split_dataset,
                                         stack_client_shards)
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import GroupedRoundEngine
    from heterofl_tpu_torch.parallel.staging import ClientStore
    from heterofl_tpu_torch.testing import assert_grid_close

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name("1_5_1_iid_fix_a2-b1-c1-e1_bn_1_1")
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=True, strategy="grouped",
               wire_codec="int8", superstep_rounds=1 if stream else 2,
               client_store="stream" if stream else "eager",
               override={"num_epochs": {"local": 2}, "conv": {"hidden_size": [16, 32]}})
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    ds = fetch_dataset("MNIST", synthetic=True, synthetic_sizes={"train": 500, "test": 40})
    split, lsplit = split_dataset(ds, 5, "iid", np.random.default_rng(0), classes_size=10)
    arrays = stack_client_shards(ds["train"].data, ds["train"].target, split["train"],
                                 list(range(5))) + (label_split_masks(lsplit, 5, 10),)
    users = np.array([[0, -1, 2, 4, -1]])
    rates = np.asarray(cfg["model_rate"], np.float32)[users]
    rng = np.random.default_rng(2)
    perms = {u: np.stack([rng.permutation(arrays[0].shape[1]) for _ in range(2)])
             for u in range(5)}
    out = []
    for dev in map(torch.device, devices):
        model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
        eng = GroupedRoundEngine(model, cfg, dev)
        data = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        P = eng.flatten(model.params())
        noise = torch.rand(eng.spec.total, generator=torch.Generator().manual_seed(5)).to(dev)
        if stream:
            store = ClientStore.from_split(ds["train"].data, ds["train"].target, split["train"],
                                           lsplit, 10)
            new, pend = eng.train_superstep(P, 0, 1, 1, None, None, None, [0.05],
                                            epoch_perms=[perms], codec_noise=[noise],
                                            cohort=eng.stage_cohort(store, users, rates))
        else:
            new, pend = eng.train_superstep(P, 0, 1, 1, data, users, rates, [0.05],
                                            epoch_perms=[perms], codec_noise=[noise])
        (ms,) = pend.fetch()
        out.append((new.cpu(), ms, eng.wire_resid_host()))
    cmax = eng.codec_slots(rates)
    counts = torch.zeros_like(out[1][0])
    for u, rate in zip(users[0], rates[0]):
        if u >= 0:
            lv = eng.levels[float(rate)]
            counts.index_add_(0, lv.idx, lv.count_masks(data[-1][[int(u)]])[0])
    s = eng.codec.scale_flat(P, cmax)
    (card, ms_card, r_card), (cpu, ms_cpu, r_cpu) = out
    what = "grouped int8 round with unfilled slots, card vs CPU" + (" (streamed, K=1)" if stream
                                                                   else "")
    assert_grid_close(f"{what}: params", card, cpu, torch.where(counts > 0, s / counts.clamp_min(1),
                                                                0.0),
                      atol=TOL_ROUND, max_share=SHARE_ROUND_INT8)
    assert_grid_close(f"{what}: residual", r_card, r_cpu, s, atol=5 * TOL_ROUND,
                      max_share=SHARE_ROUND_INT8)
    say(f"{what}: grid for {cmax} slots; n {ms_card['n'].tolist()} / {ms_cpu['n'].tolist()}")
    if not (cmax == 16 and np.array_equal(ms_card["n"], ms_cpu["n"])
            and (ms_card["n"][users[0] < 0] == 0).all() and np.any(r_card != 0)):
        raise AssertionError(f"{what}: the slots or the counts disagree")


def scenario_lm_path(torch, counters, out_dir: str):
    """Phase 10d: ``train_transformer_fed`` on the LM control at full width
    on ``SCENARIO_LM_SIZES`` (40 steps a client) with a deadline and
    buffered aggregation, two rounds eagerly and as one superstep: params,
    staleness buffer and round losses bit for bit; the fused-SGD launches
    (eager) and replays (superstep) equal the client's budgets ->
    (launches, replayed)."""
    import numpy as np

    from heterofl_tpu_torch.entry import train_transformer_fed
    from heterofl_tpu_torch.parallel import step_graph

    sched = {"deadline": {"min_frac": SCENARIO_MIN_FRAC}, "aggregation": "buffered"}
    runs, secs, launches, replayed = {}, {}, {}, {}
    for run, more in (("eager", ()), ("superstep", ("--superstep_rounds", str(SS_ROUNDS)))):
        argv = ["--control_name", LM_CONTROL, "--synthetic", "1", "--synthetic_sizes",
                json.dumps(SCENARIO_LM_SIZES), "--fused_update", "1", "--eval_interval",
                str(SS_ROUNDS), "--output_dir", os.path.join(out_dir, run), "--schedule",
                json.dumps(sched), "--override",
                json.dumps({"num_epochs": {"global": SS_ROUNDS, "local": 1}}), *more]
        say(f"scenario LM ({run}): train_transformer_fed {' '.join(argv)}")
        step_graph.reset_stats()
        zero(counters)
        t0 = time.time()
        (runs[run],) = train_transformer_fed.main(argv)
        torch.cuda.synchronize()
        secs[run] = time.time() - t0
        launches[run], replayed[run] = read(counters), dict(step_graph.REPLAYED)
    eager, sup = runs["eager"]["history"], runs["superstep"]["history"]
    total = SCENARIO_LM_SIZES["train"] // 100 // 64
    steps, _, lockstep = scenario_steps(sup, total, np.repeat(LEVELS, 20), SCENARIO_MIN_FRAC)
    bits = all(torch.equal(runs["superstep"]["params"][k], v)
               for k, v in runs["eager"]["params"].items())
    buf = np.array_equal(runs["superstep"]["sched_buf"], runs["eager"]["sched_buf"])
    same = [(r["users"], r["loss"]) for r in eager] == [(r["users"], r["loss"]) for r in sup]
    say_slots("scenario LM", sup)
    say(f"scenario LM: runs {secs['eager']:.1f} s eager, {secs['superstep']:.1f} s superstep "
        f"(host clock); steps {steps} of the lockstep budget {lockstep} (eager fused_sgd "
        f"launches {launches['eager']['fused_sgd']}, replayed {replayed['superstep']}); "
        f"superstep == eager: params bit for bit {bits}, staleness buffer {buf}, cohorts and "
        f"losses {same}")
    if not (bits and buf and same and launches["eager"]["fused_sgd"] == steps < lockstep
            and replayed["superstep"].get("fused_sgd") == steps
            and launches["superstep"]["bn_fwd"] == 0 and np.any(runs["eager"]["sched_buf"] != 0)
            and all(math.isfinite(r["loss"]) for r in sup)):
        raise AssertionError("scenario LM: the superstep differs from the eager rounds, or the "
                             f"steps {launches['eager']} / {replayed['superstep']} are not {steps}")
    mask_row_kept(torch, runs["superstep"]["params"])
    return launches["superstep"], replayed["superstep"]


def make_lm_perms(torch):
    """The transformer's leaf permutations to the checkpoint's layout."""
    from heterofl_tpu_torch.models import make_model

    return make_model(lm_cfg()).jax_perms()


def counted_run(torch, counters, main, argv, what: str):
    """One entry run, the launch counters and the replay record set to 0
    just before it and read just after -> (result, host seconds, launches,
    launches from replays)."""
    from heterofl_tpu_torch.parallel import step_graph

    say(f"{what}: {' '.join(argv)}")
    step_graph.reset_stats()
    zero(counters)
    t0 = time.time()
    (res,) = main(argv)
    torch.cuda.synchronize()
    return res, time.time() - t0, read(counters), dict(step_graph.REPLAYED)


def same_run(torch, a, b) -> bool:
    """Two runs' cohorts, logged records and metric history, params and
    residual equal bit for bit."""
    import numpy as np

    keys = ("epoch", "users", "loss", "n", "accuracy", "perplexity", "rates", "Global-Accuracy",
            "Local-Accuracy", "Global-Perplexity")
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    resid = (a["wire_resid"] is None and b["wire_resid"] is None) or (
        a["wire_resid"] is not None and b["wire_resid"] is not None
        and np.array_equal(a["wire_resid"], b["wire_resid"]))
    return ([[r.get(k) for k in keys] for r in a["history"]]
            == [[r.get(k) for k in keys] for r in b["history"]]
            and hist(a) == hist(b) and resid
            and all(torch.equal(a["params"][k], v) for k, v in b["params"].items()))


def stream_argv(out_dir: str, rounds: int, *extra):
    """The headline control's flags on ``SCENARIO_SIZES``, one local epoch,
    evaluated after the last round only."""
    return ["--control_name", HEADLINE, "--synthetic", "1", "--synthetic_sizes",
            json.dumps(SCENARIO_SIZES), "--pallas_norm", "1", "--fused_update", "1",
            "--eval_interval", str(rounds), "--output_dir", out_dir,
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1}}), *extra]


def stream_masked_path(torch, counters, out_dir: str):
    """Phase 11a: the masked headline with ``--client_store stream`` against
    the eager store, under cuDNN's deterministic algorithms: three rounds at
    K=1, and ``STREAM_ROUNDS`` at ``--superstep_rounds 2
    --stream_prefetch_depth 2`` (two cohorts prefetched) -- params, log and
    launches bit for bit (at K=1 the streamed run's replayed launches
    against the eager loop's launches); then the streamed superstep run
    resumed from its round-2 checkpoint, written while the cohorts of
    rounds 3-5 were already drawn, equal to the uninterrupted run ->
    {path: (launches, replayed)}."""
    import shutil

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.utils import checkpoint_path
    from heterofl_tpu_torch.utils.checkpoint import generation_path

    stream = ("--client_store", "stream")
    ss = ("--superstep_rounds", str(SS_ROUNDS), "--stream_prefetch_depth", "2")
    runs, secs, launches, replayed = {}, {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, rounds, more in (("eager_k1", SCENARIO_ROUNDS, ()),
                                   ("stream_k1", SCENARIO_ROUNDS, stream),
                                   ("eager_ss", STREAM_ROUNDS, ss),
                                   ("stream_ss", STREAM_ROUNDS, ss + stream)):
            runs[name], secs[name], launches[name], replayed[name] = counted_run(
                torch, counters, train_classifier_fed.main,
                stream_argv(os.path.join(out_dir, name), rounds, *more),
                f"stream masked ({name}): train_classifier_fed")
        full, cut = os.path.join(out_dir, "stream_ss"), os.path.join(out_dir, "cut")
        shutil.copytree(os.path.join(full, "model"), os.path.join(cut, "model"))
        shutil.copyfile(generation_path(checkpoint_path(full, TAG), 2), checkpoint_path(cut, TAG))
        res, secs["resumed"], launches["resumed"], replayed["resumed"] = counted_run(
            torch, counters, train_classifier_fed.main,
            stream_argv(cut, STREAM_ROUNDS, *ss, *stream, "--resume_mode", "1"),
            "stream masked (resumed from round 2): train_classifier_fed")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # a streamed K=1 run is a run of one-round supersteps: its steps replay
    # captured graphs (whose warm-up steps launch too), the eager loop's run
    # eagerly -- the same kernels a step
    k1 = same_run(torch, runs["stream_k1"], runs["eager_k1"]) and all(
        replayed["stream_k1"].get(k, 0) == v for k, v in launches["eager_k1"].items())
    sup = same_run(torch, runs["stream_ss"], runs["eager_ss"]) \
        and launches["stream_ss"] == launches["eager_ss"] \
        and replayed["stream_ss"] == replayed["eager_ss"]
    hist = runs["stream_ss"]["history"]
    resumed = [r["epoch"] for r in res["history"]] == [3, 4, 5] \
        and [r["users"] for r in res["history"]] == [r["users"] for r in hist[2:]] \
        and all(torch.equal(res["params"][k], v) for k, v in runs["stream_ss"]["params"].items())
    say("stream masked: runs " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
        + " (host clock); stream == eager bit for bit (params, log, launches): K=1 "
        f"{k1}, superstep at depth 2 {sup}; resumed at the boundary == uninterrupted {resumed}; "
        f"launches K=1 {launches['stream_k1']}, superstep {launches['stream_ss']}, from replays "
        f"{replayed['stream_ss']}")
    if not (k1 and sup and resumed and all(math.isfinite(r["loss"]) for r in hist)):
        raise AssertionError("stream masked: a streamed run differs from the eager store's, or "
                             "the resumed run from the uninterrupted one")
    return {"stream_masked_k1": (launches["stream_k1"], replayed["stream_k1"]),
            "stream_masked_superstep": (launches["stream_ss"], replayed["stream_ss"]),
            "stream_masked_resumed": (launches["resumed"], replayed["resumed"])}


def stream_grouped_path(torch, counters, out_dir: str):
    """Phase 11b: the grouped headline superstep (``SCENARIO_ROUNDS``
    rounds, ``--superstep_rounds 2``) with the stream store against the
    eager store, bit for bit (params, log, launches, replays); the eager
    store refuses a grouped int8 run at K=1, which the stream store runs
    (held on the card against the CPU by :func:`scenario_grouped_int8_phase`)
    -> (launches, replayed)."""
    from heterofl_tpu_torch.entry import train_classifier_fed

    ss = ("--strategy", "grouped", "--superstep_rounds", str(SS_ROUNDS))
    runs, secs, launches, replayed = {}, {}, {}, {}
    for name, more in (("eager", ()), ("stream", ("--client_store", "stream"))):
        runs[name], secs[name], launches[name], replayed[name] = counted_run(
            torch, counters, train_classifier_fed.main,
            stream_argv(os.path.join(out_dir, name), SCENARIO_ROUNDS, *ss, *more),
            f"stream grouped ({name}): train_classifier_fed")
    try:
        train_classifier_fed.main(stream_argv(os.path.join(out_dir, "k1"), 1, "--strategy",
                                              "grouped", "--wire_codec", "int8"))
        refused = None
    except ValueError as e:
        refused = str(e)
    same = same_run(torch, runs["stream"], runs["eager"]) \
        and launches["stream"] == launches["eager"] and replayed["stream"] == replayed["eager"]
    say(f"stream grouped: runs {secs['eager']:.1f} s eager store, {secs['stream']:.1f} s stream "
        f"store (host clock); stream == eager bit for bit {same}; launches {launches['stream']}, "
        f"from replays {replayed['stream']}; the eager store at K=1 with int8: {refused}")
    if not (same and refused and "client_store='stream'" in refused
            and not any(launches["stream"][k] for k in ("bn_fwd", "bn_bwd", "fused_sgd"))):
        raise AssertionError("stream grouped: the streamed superstep differs from the eager "
                             "store's, or the eager store did not refuse int8 at K=1")
    return launches["stream"], replayed["stream"]


def stream_lm_path(torch, counters, out_dir: str):
    """Phase 11c: the LM control at full width on ``SCENARIO_LM_SIZES`` (40
    steps a client), a superstep of two rounds, with the stream store
    against the eager store, bit for bit -> (launches, replayed)."""
    from heterofl_tpu_torch.entry import train_transformer_fed

    runs, secs, launches, replayed = {}, {}, {}, {}
    for name, more in (("eager", ()), ("stream", ("--client_store", "stream"))):
        argv = ["--control_name", LM_CONTROL, "--synthetic", "1", "--synthetic_sizes",
                json.dumps(SCENARIO_LM_SIZES), "--fused_update", "1", "--eval_interval",
                str(SS_ROUNDS), "--superstep_rounds", str(SS_ROUNDS), "--output_dir",
                os.path.join(out_dir, name), "--override",
                json.dumps({"num_epochs": {"global": SS_ROUNDS, "local": 1}}), *more]
        runs[name], secs[name], launches[name], replayed[name] = counted_run(
            torch, counters, train_transformer_fed.main, argv,
            f"stream LM ({name}): train_transformer_fed")
    same = same_run(torch, runs["stream"], runs["eager"]) \
        and launches["stream"] == launches["eager"] and replayed["stream"] == replayed["eager"]
    say(f"stream LM: runs {secs['eager']:.1f} s eager store, {secs['stream']:.1f} s stream store "
        f"(host clock); stream == eager bit for bit {same}; launches {launches['stream']}, from "
        f"replays {replayed['stream']}")
    if not (same and replayed["stream"].get("fused_sgd", 0) > 0
            and all(math.isfinite(r["loss"]) for r in runs["stream"]["history"])):
        raise AssertionError("stream LM: the streamed superstep differs from the eager store's")
    mask_row_kept(torch, runs["stream"]["params"])
    return launches["stream"], replayed["stream"]


def population_cfg(users: int, depth: int = 1):
    """The headline's full-width ResNet-18 on CIFAR10 over ``users`` users
    (the reference's acceptance shape, tests/test_streaming.py:384-437):
    the prp sampler, one local epoch."""
    from heterofl_tpu_torch import config as C

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(
        f"1_{users}_{POP_ACTIVE / users:g}_iid_fix_a1-b1-c1-d1-e1_bn_1_1")
    cfg.update(data_name="CIFAR10", model_name="resnet18", pallas_norm=True, sampler="prp",
               client_store="stream", stream_prefetch_depth=depth,
               override={"num_epochs": {"local": 1}})
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def population_phase(torch, counters, device: str = "cuda"):
    """Phase 11d: span stores of ``POP_USERS`` users over ``POP_ITEMS``
    synthetic CIFAR10 images, shard ``POP_SHARD``, the prp sampler, A =
    ``POP_ACTIVE``; ``stage_cohort`` for k = 2 at each population, timed
    on the host clock (the median of ``POP_STAGE_CALLS`` calls; and until
    the copy's event), the device bytes the cohort allocates and the
    store's metadata bytes.  The cohort's device bytes must be equal at
    both populations and the host seconds at 1e6 users under
    ``POP_TIME_RATIO`` times those at 1e4 (the reference's bound); then one
    streamed superstep of two rounds on full-width ResNet-18 from the 1e6
    cohort trains (finite losses, n > 0) -> ((launches, replayed),
    numbers).  ``device`` ``cpu`` rehearses the phase (no device bytes)."""
    import numpy as np

    from heterofl_tpu_torch.data import fetch_dataset, span_population
    from heterofl_tpu_torch.fed.core import superstep_rate_schedule, superstep_user_schedule
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import RoundEngine, step_graph
    from heterofl_tpu_torch.parallel.staging import ClientStore

    dev = torch.device(device)
    allocated_now = torch.cuda.memory_allocated if dev.type == "cuda" else (lambda: 0)
    tr = fetch_dataset("CIFAR10", synthetic=True,
                       synthetic_sizes={"train": POP_ITEMS, "test": 10})["train"]
    model = make_model(population_cfg(POP_USERS[0])).init_(
        torch.Generator().manual_seed(0)).to(dev)
    nums = {}
    for users in POP_USERS:
        cfg = population_cfg(users)
        eng = RoundEngine(model, cfg, dev)
        t0 = time.perf_counter()
        store = ClientStore.from_spans(tr.data, tr.target,
                                       *span_population(POP_ITEMS, users, POP_SHARD), 10)
        build_s = time.perf_counter() - t0
        sched = superstep_user_schedule(0, 1, SS_ROUNDS, users, POP_ACTIVE, "prp")
        rates = superstep_rate_schedule(0, 1, SS_ROUNDS, cfg, sched)
        before = allocated_now()
        host_s, copy_s, allocated = [], [], None
        for i in range(POP_STAGE_CALLS):
            t0 = time.perf_counter()
            coh = eng.stage_cohort(store, sched, rates)
            host_s.append(time.perf_counter() - t0)
            if coh.ready is not None:
                coh.ready.synchronize()
            copy_s.append(time.perf_counter() - t0)
            if allocated is None:
                allocated = allocated_now() - before
            if i + 1 < POP_STAGE_CALLS:
                coh.release()
        nums[users] = {"stage_host_s": statistics.median(host_s),
                       "stage_copied_s": statistics.median(copy_s), "build_s": build_s,
                       "allocated_before": before, "cohort_allocated": allocated,
                       "cohort_bytes": sum(t.numel() * t.element_size() for t in coh.data),
                       "metadata_nbytes": store.metadata_nbytes}
        say(f"population {users:,} users (span store over {POP_ITEMS:,} images, shard "
            f"{POP_SHARD}): store built in {build_s:.4f} s, metadata {store.metadata_nbytes:,} B; "
            f"stage_cohort k={SS_ROUNDS} A={POP_ACTIVE}: host {nums[users]['stage_host_s']:.4f} s "
            f"(median of {POP_STAGE_CALLS}; calls {[round(s, 4) for s in host_s]}), "
            f"{nums[users]['stage_copied_s']:.4f} s until its copy ended (host clock); "
            f"torch.cuda.memory_allocated {before:,} B before, the cohort's slot {allocated:,} B, "
            f"cohort tensors {nums[users]['cohort_bytes']:,} B")
    small, big = nums[POP_USERS[0]], nums[POP_USERS[-1]]
    ratio = big["stage_host_s"] / max(small["stage_host_s"], 1e-9)
    say(f"population: staging at {POP_USERS[-1]:,} users takes {ratio:.3f}x the host seconds at "
        f"{POP_USERS[0]:,} (bound {POP_TIME_RATIO}x); cohort device bytes "
        f"{big['cohort_allocated']:,} / {small['cohort_allocated']:,}")
    if not (big["cohort_allocated"] == small["cohort_allocated"]
            and big["cohort_bytes"] == small["cohort_bytes"]
            and (dev.type == "cpu" or big["cohort_allocated"] >= big["cohort_bytes"])
            and ratio < POP_TIME_RATIO
            and big["metadata_nbytes"] == 2 * POP_USERS[-1] * 8):
        raise AssertionError("population: staging a cohort depends on the population's size")
    step_graph.reset_stats()
    zero(counters)
    t0 = time.time()
    P = eng.flatten(model.params())
    P, pend = eng.train_superstep(P, 0, 1, SS_ROUNDS, None, None, None, [0.1] * SS_ROUNDS,
                                  cohort=coh)
    rounds = pend.fetch()
    secs = time.time() - t0
    launches, replayed = read(counters), dict(step_graph.REPLAYED)
    losses = [float(np.sum(r["loss_sum"]) / max(np.sum(r["n"]), 1)) for r in rounds]
    n = [float(np.sum(r["n"])) for r in rounds]
    say(f"population: one streamed superstep of {SS_ROUNDS} rounds on full-width ResNet-18 from "
        f"the {POP_USERS[-1]:,}-user cohort {sched.tolist()}: {secs:.1f} s (host clock), losses "
        f"{losses}, n {n}; launches {launches}, from replays {replayed}")
    if not (all(math.isfinite(v) for v in losses) and all(v > 0 for v in n)
            and bool(torch.isfinite(P).all())):
        raise AssertionError("population: the streamed superstep did not train")
    nums["ratio"] = ratio
    return (launches, replayed), nums


def ring_phase(torch, device: str = "cuda") -> dict:
    """Phase 11e: the cohort ring on the card at depth 1 and 2: over
    ``RING_SUPERSTEPS`` masked supersteps of two rounds (full-width
    ResNet-18, a span store of 10,000 users, shard ``RING_SHARD``), the
    next ``depth`` cohorts are staged right after each superstep is
    dispatched, while it runs; each cohort is held across its superstep and
    copied out on the compute stream right after it, then released.  Every
    copy must equal the host gather of its schedule bit for bit.  At the
    end of each prefetch a ``torch.cuda.Event.query()`` of the superstep's
    end says whether the device was still busy; the copy's end against the
    superstep's end is read from their events -> {depth: numbers}.
    ``device`` ``cpu`` rehearses the phase (no events)."""
    import numpy as np

    from heterofl_tpu_torch.data import fetch_dataset, span_population
    from heterofl_tpu_torch.fed.core import superstep_rate_schedule, superstep_user_schedule
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import RoundEngine
    from heterofl_tpu_torch.parallel.staging import ClientStore

    users, dev = POP_USERS[0], torch.device(device)
    tr = fetch_dataset("CIFAR10", synthetic=True,
                       synthetic_sizes={"train": POP_ITEMS, "test": 10})["train"]
    store = ClientStore.from_spans(tr.data, tr.target,
                                   *span_population(POP_ITEMS, users, RING_SHARD), 10)
    model = make_model(population_cfg(users)).init_(torch.Generator().manual_seed(0)).to(dev)
    out = {}
    for depth in (1, 2):
        cfg = population_cfg(users, depth)
        eng = RoundEngine(model, cfg, dev)
        scheds = [superstep_user_schedule(0, 1 + SS_ROUNDS * i, SS_ROUNDS, users, POP_ACTIVE,
                                          "prp") for i in range(RING_SUPERSTEPS)]
        rates = [superstep_rate_schedule(0, 1 + SS_ROUNDS * i, SS_ROUNDS, cfg, s)
                 for i, s in enumerate(scheds)]
        queue = [(0, eng.stage_cohort(store, scheds[0], rates[0]))]
        P = eng.flatten(model.params())
        copies, prefetches, pends = [], [], []
        for i in range(RING_SUPERSTEPS):
            _, coh = queue.pop(0)
            data = coh.open("masked", SS_ROUNDS)  # held: copied out after its superstep
            P, pend = eng.train_superstep(P, 0, 1 + SS_ROUNDS * i, SS_ROUNDS, None, None, None,
                                          [0.1] * SS_ROUNDS, cohort=coh)
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event(enable_timing=True)
                done.record()
            copies.append(tuple(t.clone() for t in data))
            coh.release()
            while len(queue) < depth and i + 1 + len(queue) < RING_SUPERSTEPS:
                j = i + 1 + len(queue)
                nxt = eng.stage_cohort(store, scheds[j], rates[j])
                queue.append((j, nxt))
                prefetches.append((i, j, done is not None and not done.query(), done,
                                   nxt.ready))
            pends.append(pend)
        losses = [float(np.sum(r["loss_sum"])) for p in pends for r in p.fetch()]
        equal = []
        for cp, sched in zip(copies, scheds):
            host = [np.empty(shape, dt) for shape, dt in store.layouts(sched.size)]
            store.fill(sched.reshape(-1), host)
            equal.append(all(np.array_equal(c.cpu().numpy(), h) for c, h in zip(cp, host)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        lead = [round(done.elapsed_time(ready), 3) for _, _, _, done, ready in prefetches
                if done is not None]
        busy = [b for _, _, b, _, _ in prefetches]
        say(f"ring depth {depth}: {RING_SUPERSTEPS} supersteps, cohorts staged "
            f"{[(i, j) for i, j, *_ in prefetches]} (superstep in flight, cohort staged); each "
            f"committed cohort copied out after its superstep == the host gather {equal}; the "
            f"device still busy with the superstep at the end of each prefetch (Event.query) "
            f"{busy}; the copy's end minus the superstep's end {lead} ms (device clock, "
            f"negative: the copy ended first)")
        if not (all(equal) and all(math.isfinite(v) for v in losses)):
            raise AssertionError(f"ring depth {depth}: a committed cohort changed")
        out[depth] = {"equal": equal, "busy": busy, "copy_minus_superstep_ms": lead}
    return out


# ---------------------------------------------------------------------------
# 12. observability and its guards
# ---------------------------------------------------------------------------

OBS_ROUNDS = 5  # phase 12a: supersteps of 2, 2 and 1 -- the captures, the profiled one, the timed tail
OBS_POISONED = 50  # phase 12c poisons users 0 .. 49 in round 2


def profile_kernels(path: str) -> dict:
    """The hand-written kernels a ``profile_dir`` Chrome trace names, counted
    by launch counter (:data:`KERNEL_OF`)."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    return {k: sum(1 for n in names if re.search(rf"\b{pat}\b", n))
            for k, pat in KERNEL_OF.items()}


def obs_masked_path(torch, counters, out_dir: str):
    """Phase 12a: the masked headline at ``--superstep_rounds 2``,
    ``OBS_ROUNDS`` rounds (supersteps of 2, 2 and the tail of 1), plain and
    under ``--telemetry hist --ledger on --trace_dir --profile_dir`` (the
    profile of the first steady superstep), under cuDNN's deterministic
    algorithms: params, log, launches and replays bit for bit; the metrics'
    device-to-host fetches (``host_fetch`` calls) one a superstep in both;
    every round's probe record finite with its histograms; ``trace.json``
    loads, every ``events.jsonl`` line has the schema's fields,
    ``ledger.npz`` renders its report, and the profile names the BN and SGD
    kernels; the tail round's ``update_norm`` against the norm of its
    params minus the round-4 checkpoint's (float64 on the host) within 1e-5
    relative; the tail's device seconds, plain and observed.  Then, through
    an engine's own methods at the headline's 11,172,170 params: the
    probes' kernels a round and the gate's a client (:func:`graph_kernels`),
    the probes' device time, and the staleness histogram of a
    ``[2, n]`` carry (past 2**24 entries) against the host's exact counts
    -> ({path: (launches, replayed)}, numbers)."""
    import numpy as np

    from heterofl_tpu_torch.convert import params_from_jax
    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.obs.hist import STALE_EDGES, stale_hist
    from heterofl_tpu_torch.obs.probes import round_probes, segment_ends
    from heterofl_tpu_torch.obs.report import build_report
    from heterofl_tpu_torch.obs.trace import EVENT_FIELDS
    from heterofl_tpu_torch.ops.fused_update import FlatSpec
    from heterofl_tpu_torch.parallel import staging
    from heterofl_tpu_torch.parallel.round_engine import FlatParams
    from heterofl_tpu_torch.utils import checkpoint_path
    from heterofl_tpu_torch.utils.checkpoint import generation_paths, load_checkpoint

    trace_dir, prof_dir = os.path.join(out_dir, "trace"), os.path.join(out_dir, "profile")
    ss = ("--superstep_rounds", str(SS_ROUNDS))
    runs, secs, launches, replayed, fetches = {}, {}, {}, {}, {}
    real_fetch, calls = staging.host_fetch, []

    def counted_fetch(tree):
        calls.append(1)
        return real_fetch(tree)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    staging.host_fetch = counted_fetch
    try:
        for name, more in (("off", ()), ("hist", ("--telemetry", "hist", "--ledger", "on",
                                                  "--trace_dir", trace_dir,
                                                  "--profile_dir", prof_dir))):
            calls.clear()
            runs[name], secs[name], launches[name], replayed[name] = counted_run(
                torch, counters, train_classifier_fed.main,
                stream_argv(os.path.join(out_dir, name), OBS_ROUNDS, *ss, *more),
                f"obs masked ({name}): train_classifier_fed")
            fetches[name] = len(calls)
    finally:
        staging.host_fetch = real_fetch
        torch.backends.cudnn.deterministic = deterministic
    off, hist = runs["off"]["history"], runs["hist"]["history"]
    supersteps = -(-OBS_ROUNDS // SS_ROUNDS)
    same = same_run(torch, runs["hist"], runs["off"]) and launches["hist"] == launches["off"] \
        and replayed["hist"] == replayed["off"]
    recs = [r.get("probes") for r in hist]
    probes_ok = all(rec is not None and rec["nonfinite"] == 0
                    and math.isfinite(rec["update_norm"]) and rec["update_norm"] > 0
                    and sum(rec["participation"]) == r["filled"] - r["failed"]
                    and len(rec["hist_loss"]) == 11
                    and sum(rec["hist_steps"]) == r["filled"] - r["failed"]
                    for rec, r in zip(recs, hist))
    tdir = os.path.join(trace_dir, TAG)
    with open(os.path.join(tdir, "trace.json")) as f:
        trace_events = json.load(f)["traceEvents"]
    with open(os.path.join(tdir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    schema = all(set(EVENT_FIELDS) <= set(e) for e in events)
    report = build_report(os.path.join(tdir, "ledger.npz"))
    prof = profile_kernels(os.path.join(prof_dir, f"{TAG}.pt.trace.json"))
    # the tail round's update against the round-4 checkpoint's params
    cfg = C_process(stream_argv(os.path.join(out_dir, "hist"), OBS_ROUNDS))
    blob = next(b for b in map(load_checkpoint, generation_paths(
        checkpoint_path(os.path.join(out_dir, "hist"), TAG))) if b["epoch"] == OBS_ROUNDS)
    before = params_from_jax(blob["params"], make_model(cfg).jax_perms())
    host = math.sqrt(sum(float(np.sum((runs["hist"]["params"][k].cpu().numpy().astype(np.float64)
                                       - v.numpy().astype(np.float64)) ** 2))
                         for k, v in before.items()))
    rel = abs(recs[-1]["update_norm"] - host) / host
    dev_off, dev_on = off[-1]["seconds"], hist[-1]["seconds"]
    say(f"obs masked: runs {secs['off']:.1f} s off, {secs['hist']:.1f} s hist + ledger + trace + "
        f"profile (host clock); hist == off bit for bit (params, log, launches, replays) {same}; "
        f"host_fetch calls {fetches['off']} off, {fetches['hist']} hist for {supersteps} "
        f"supersteps; records {probes_ok} (round 1: {recs[0]}); trace {len(trace_events)} events, "
        f"events.jsonl {len(events)} lines, schema {schema}; ledger coverage "
        f"{report['participation']['coverage']}, {report['bytes']} B; profile kernels {prof}; "
        f"the tail round's update_norm {recs[-1]['update_norm']:.7g} against the fetched "
        f"params' {host:.7g} (relative {rel:.2e}); its device seconds (device clock) off "
        f"{dev_off:.4f}, hist {dev_on:.4f}")
    if not (same and fetches["hist"] == fetches["off"] == supersteps and probes_ok and schema
            and events and report["updates"] == OBS_ROUNDS and rel <= 1e-5
            and all(prof[k] > 0 for k in ("bn_fwd", "bn_bwd", "fused_sgd"))):
        raise AssertionError("obs masked: the observed run differs from the plain one, fetched "
                             "more than once a superstep, or its records, norm, trace, ledger "
                             "or profile are wrong")
    # the engine's probe and gate methods at the headline's width
    eng = FlatParams()
    eng.spec = FlatSpec.of(dict(make_model(cfg).named_parameters()))
    eng._init_obs(dict(cfg, telemetry="hist", quarantine="on"))
    n, dev = eng.spec.total, next(iter(runs["hist"]["params"].values())).device
    gen = torch.Generator(device=dev).manual_seed(0)
    P0 = torch.randn(n, generator=gen, device=dev)
    P1 = P0 + 0.01 * torch.randn(n, generator=gen, device=dev)
    S, Cn = P1 * 3.0, torch.full((n,), 3.0, device=dev)
    ends = segment_ends(eng.spec, dev)
    n_on = graph_kernels(lambda: round_probes(ends, P0, P1, S, Cn))
    n_hist = graph_kernels(lambda: eng._round_obs(P0, P1, S, Cn))
    n_gate = graph_kernels(lambda: eng._guard(P1, P0, Cn, None))
    probe_ms = time_ms(lambda: eng._round_obs(P0, P1, S, Cn))
    buf = torch.randn((2, n), generator=gen, device=dev) * 10.0 ** torch.randint(
        -9, 3, (2, n), generator=gen, device=dev)
    dev_hist = stale_hist(buf, buf.device).cpu().numpy().astype(np.float64)
    host_int = np.bincount(np.searchsorted(np.asarray(STALE_EDGES, np.float32),
                                           np.abs(buf.cpu().numpy()).reshape(-1), side="left"),
                           minlength=len(STALE_EDGES) + 1)
    stale_exact = np.array_equal(dev_hist[0] * 2.0 ** 24 + dev_hist[1], host_int)
    del eng, P0, P1, S, Cn, buf
    torch.cuda.empty_cache()
    say(f"obs masked: kernels a round at {n} params (kernel nodes of a captured call): probes "
        f"{n_on} (telemetry on), {n_hist} (hist), the gate {n_gate} a client; the hist probes "
        f"{probe_ms:.4f} ms a round (CUDA events); the staleness histogram of {2 * n} entries on "
        f"the card equal to the host's exact counts {stale_exact} ({host_int.tolist()})")
    if not stale_exact:
        raise AssertionError("obs masked: the staleness histogram on the card is not the host's")
    return ({"obs_masked_hist": (launches["hist"], replayed["hist"])},
            {"probe_kernels_on": n_on, "probe_kernels_hist": n_hist, "gate_kernels": n_gate,
             "probe_ms": probe_ms, "superstep_s_off": dev_off, "superstep_s_hist": dev_on,
             "norm_rel": rel, "off_run": off})


def C_process(argv):
    """The processed cfg of ``train_classifier_fed``'s flags ``argv`` (CIFAR10:
    10 classes)."""
    from heterofl_tpu_torch.entry.common import parse_cfg

    return dict(parse_cfg("chip_smoke", "resnet18", "CIFAR10", argv), classes_size=10)


def obs_grouped_lm_path(torch, counters, out_dir: str):
    """Phase 12b: the grouped headline superstep (``SS_ROUNDS`` rounds) and
    the LM control's superstep, each plain and under ``--telemetry on``:
    params, log, launches and replays bit for bit; every round's record
    finite, no non-finite leaf -> {path: (launches, replayed)}."""
    from heterofl_tpu_torch.entry import train_classifier_fed, train_transformer_fed

    ss = ("--superstep_rounds", str(SS_ROUNDS))
    lm_argv = lambda d, *more: ["--control_name", LM_CONTROL, "--synthetic", "1",  # noqa: E731
                                "--synthetic_sizes", json.dumps(SCENARIO_LM_SIZES),
                                "--fused_update", "1", "--eval_interval", str(SS_ROUNDS), *ss,
                                "--output_dir", d, "--override",
                                json.dumps({"num_epochs": {"global": SS_ROUNDS, "local": 1}}),
                                *more]
    out = {}
    for path, main, argv in (
            ("obs_grouped_on", train_classifier_fed.main,
             lambda d, *more: stream_argv(d, SS_ROUNDS, "--strategy", "grouped", *ss, *more)),
            ("obs_lm_on", train_transformer_fed.main, lm_argv)):
        runs, secs, launches, replayed = {}, {}, {}, {}
        for name, more in (("off", ()), ("on", ("--telemetry", "on"))):
            runs[name], secs[name], launches[name], replayed[name] = counted_run(
                torch, counters, main, argv(os.path.join(out_dir, path, name), *more),
                f"{path} ({name})")
        same = same_run(torch, runs["on"], runs["off"]) and launches["on"] == launches["off"] \
            and replayed["on"] == replayed["off"]
        recs = [r.get("probes") for r in runs["on"]["history"]]
        ok = all(rec is not None and rec["nonfinite"] == 0 and math.isfinite(rec["grad_norm"])
                 and rec["update_norm"] > 0 for rec in recs)
        say(f"{path}: runs {secs['off']:.1f} s off, {secs['on']:.1f} s on (host clock); on == off "
            f"bit for bit {same}; records {ok}: {recs}; from replays {replayed['on']}")
        if not (same and ok):
            raise AssertionError(f"{path}: telemetry='on' changed the run, or a record is missing "
                                 f"or not finite")
        out[path] = (launches["on"], replayed["on"])
    return out


def obs_quarantine_path(torch, counters, out_dir: str):
    """Phase 12c: ``--chaos_poison`` on users 0 .. ``OBS_POISONED - 1`` in
    round 2 under ``--quarantine on --telemetry on``, masked and grouped,
    a superstep of two rounds: params finite, no non-finite leaf, round 2's
    ``quarantined`` the count of its trained clients the plan poisons,
    their rates 0, round 1 gating none -> {path: (launches, replayed)}."""
    from heterofl_tpu_torch.entry import train_classifier_fed

    poison = json.dumps([[2, u] for u in range(OBS_POISONED)])
    out = {}
    for strategy in ("masked", "grouped"):
        path = f"obs_quarantine_{strategy}"
        res, secs, n, rep = counted_run(
            torch, counters, train_classifier_fed.main,
            stream_argv(os.path.join(out_dir, path), SS_ROUNDS, "--strategy", strategy,
                        "--superstep_rounds", str(SS_ROUNDS), "--quarantine", "on",
                        "--telemetry", "on", "--chaos_poison", poison), path)
        r2 = res["history"][1]
        hit = [i for i, u in enumerate(r2["users"]) if 0 <= u < OBS_POISONED]
        recs = [r["probes"] for r in res["history"]]
        finite = all(bool(torch.isfinite(v).all()) for v in res["params"].values())
        say(f"{path}: {secs:.1f} s (host clock); round 2 cohort {r2['users']}, {len(hit)} "
            f"poisoned; quarantined {[rec['quarantined'] for rec in recs]}; params finite "
            f"{finite}; non-finite leaves {[rec['nonfinite'] for rec in recs]}")
        if not (finite and hit and recs[1]["quarantined"] == len(hit)
                and recs[0]["quarantined"] == 0
                and all(r2["user_rates"][i] == 0 for i in hit)
                and all(rec["nonfinite"] == 0 for rec in recs)):
            raise AssertionError(f"{path}: the gate did not quarantine exactly the poisoned "
                                 f"clients, or the params are not finite")
        out[path] = (n, rep)
    return out


def obs_rollback_path(torch, counters, out_dir: str, off_history):
    """Phase 12d: the masked headline at ``--superstep_rounds 2``, four
    rounds, round 3's first drawn user (of phase 12a's plain run, the same
    draws) poisoned, under ``--telemetry on --watchdog '{"action":
    "rollback"}'`` and a trace: the run recovers -- params finite, a
    recovery record after the trip in the log and in ``events.jsonl`` ->
    (launches, replayed)."""
    from heterofl_tpu_torch.entry import train_classifier_fed

    uid = next(u for u in off_history[2]["users"] if u >= 0)
    d = os.path.join(out_dir, "rollback")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, secs, n, rep = counted_run(
            torch, counters, train_classifier_fed.main,
            stream_argv(d, 4, "--superstep_rounds", str(SS_ROUNDS), "--telemetry", "on",
                        "--chaos_poison", json.dumps([[3, int(uid)]]), "--trace_dir",
                        os.path.join(d, "trace"), "--watchdog",
                        json.dumps({"action": "rollback", "max_retries": 3, "backoff": 0.0})),
            "obs rollback")
    with open(os.path.join(d, "runs", f"train_{TAG}", "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    with open(os.path.join(d, "trace", TAG, "events.jsonl")) as f:
        names = [json.loads(line)["name"] for line in f]
    trips = [i for i, r in enumerate(log) if r.get("event") == "watchdog"]
    recs = [r for r in log if r.get("tag") == "recovery"]
    finite = all(bool(torch.isfinite(v).all()) for v in res["params"].values())
    say(f"obs rollback: user {uid} poisoned in round 3; {secs:.1f} s (host clock); trips "
        f"{len(trips)}, recoveries {[(r['attempt'], r['restored_epoch']) for r in recs]}; "
        f"params finite {finite}; rounds {[r['epoch'] for r in res['history']]}; warnings "
        f"{sum('rollback attempt' in str(w.message) for w in caught)}")
    if not (finite and trips and recs and recs[0]["restored_epoch"] == 3
            and [r["epoch"] for r in res["history"]] == [1, 2, 3, 4]
            and "watchdog" in names and "recovery" in names
            and names.index("watchdog") < names.index("recovery")):
        raise AssertionError("obs rollback: the poisoned run did not recover through a rollback")
    return n, rep


MESH_SIZES = {"train": 1000, "test": 200}  # phase 15: a local step a client
MESH_ROUNDS = 2  # K=1 rounds, or one superstep of two
MESH_RUNS = tuple((codec, k) for codec in ("dense", "int8") for k in (1, MESH_ROUNDS))
MESH_RANKS = 2  # phase 15c: the entry and the probe at two ranks
MESH_RANK_TIMEOUT = 300  # seconds for the ranks' whole spawn
ARMS_SIZES = {"train": 1000, "test": 100}  # phase 13: a step a client, at full width
ARMS_ROUNDS = 2  # one superstep of two rounds, evaluated after the second
ARMS_SPEC = {"count": 2, "seeds": [None, 1], "lr_scales": [1.0, 0.5]}
ARMS_SOLO = {"count": 1, "seeds": [1], "lr_scales": [0.5]}
DRILL_ROUNDS = 4  # the masked drills: supersteps of two, as the drill's own federation
# the poison drills: the poison at round 3 (``chaos.drill.run_poison_drill``)
# and no round after it (cut from DRILL_ROUNDS when phase 16 came)
DRILL_POISON_ROUNDS = 3
DRILL_MASKED = {"kills": [{"point": "superstep", "at": 2}, {"point": "fetch", "at": 2},
                          {"point": "checkpoint", "at": 2}]}
# the grouped plan, three rounds at K=1: a kill before the third checkpoint
# write, the live blob corrupted (the resume falls back a generation), then
# a kill at a dispatch and one at a fetch
DRILL_GROUPED = {"kills": [{"point": "checkpoint", "at": 3}, {"point": "superstep", "at": 5},
                           {"point": "fetch", "at": 5}],
                 "corrupt": [{"which": "checkpoint", "mode": "flip", "generation": 0}]}
DRILL_GROUPED_ROUNDS = 3
ROWS = {"masked": ("bn_fwd", "bn_bwd", "fused_sgd"),
        "grouped": ("bn_fwd_batched", "bn_bwd_batched", "fused_sgd_batched")}


def arms_argv(out_dir: str, rounds: int, *extra):
    """The headline control's flags on ``ARMS_SIZES``: ``rounds`` rounds in
    supersteps of two, one local epoch, evaluated every second round."""
    return ["--control_name", HEADLINE, "--synthetic", "1", "--synthetic_sizes",
            json.dumps(ARMS_SIZES), "--pallas_norm", "1", "--fused_update", "1",
            "--eval_interval", str(SS_ROUNDS), "--superstep_rounds", str(SS_ROUNDS),
            "--output_dir", out_dir,
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1}}), *extra]


def arms_run(torch, counters, argv, what: str):
    """One run of ``FedExperiment`` (no ``--arms``) or ``ArmsExperiment``
    on the entry's flags, the counters, the replay record and a count of
    ``staging.host_fetch`` calls set to 0 just before it and read just
    after -> (result, experiment, host seconds, launches, replayed, fetches,
    the graphs' record: captures and pool bytes)."""
    from heterofl_tpu_torch.entry.common import ArmsExperiment, FedExperiment, parse_cfg
    from heterofl_tpu_torch.parallel import staging, step_graph

    cfg = parse_cfg("chip_smoke", "resnet18", "CIFAR10", argv)
    fetches, host_fetch = [0], staging.host_fetch

    def counted(tree):
        fetches[0] += 1
        return host_fetch(tree)

    say(f"{what}: {' '.join(argv)}")
    step_graph.reset_stats()
    zero(counters)
    staging.host_fetch = counted
    t0 = time.time()
    try:
        exp = (ArmsExperiment if cfg.get("arms") else FedExperiment)(cfg, 0)
        res = exp.run()
        torch.cuda.synchronize()
    finally:
        staging.host_fetch = host_fetch
    return (res, exp, time.time() - t0, read(counters), dict(step_graph.REPLAYED), fetches[0],
            dict(step_graph.STATS))


def arms_path(torch, counters, out_dir: str, strategy: str):
    """Phase 13a (masked, under ``--wire_codec int8``) and 13b (grouped,
    dense): the headline at full width, one superstep of ``ARMS_ROUNDS``
    rounds, plain, as E=2 arms (seeds [None, 1], scales [1, 0.5]) and as
    arm 1's solo arms run, under cuDNN's deterministic algorithms: arm 0
    equals the plain run bit for bit, arm 1 its solo run (params; masked:
    the per-arm residuals); one ``host_fetch`` a superstep; rows 1-3 (1b-3b)
    replayed E times the solo run's (the arms loop over their clients'
    captured steps); the E-arm superstep's device seconds beside the plain
    and solo runs' (each run's first superstep: its captures included).
    Masked also (13c): quantise-and-pack a round an arm, and round 2
    resumed from the round-1 blob of an arms run equal to the uninterrupted
    arms run (params, residuals) -> {path: (launches, replayed)}."""
    import numpy as np

    from heterofl_tpu_torch.chaos.drill import deterministic_cudnn

    runs, codec = {}, ("--wire_codec", "int8") if strategy == "masked" else ()
    E = ARMS_SPEC["count"]
    with deterministic_cudnn():
        for name, more in (("plain", ()), ("arms", ("--arms", json.dumps(ARMS_SPEC))),
                           ("solo", ("--arms", json.dumps(ARMS_SOLO)))):
            argv = arms_argv(os.path.join(out_dir, strategy, name), ARMS_ROUNDS, "--strategy",
                             strategy, *codec, *more)
            runs[name] = arms_run(torch, counters, argv, f"arms {strategy} ({name})")
        if strategy == "masked":
            cut = os.path.join(out_dir, strategy, "cut")
            more = ("--strategy", strategy, *codec, "--arms", json.dumps(ARMS_SPEC))
            arms_run(torch, counters, arms_argv(cut, 1, *more), "arms int8 (round 1)")
            runs["resumed"] = arms_run(torch, counters, arms_argv(cut, ARMS_ROUNDS, *more,
                                                                  "--resume_mode", "1"),
                                       "arms int8 (round 2 resumed)")
    plain, arms, solo = (runs[n][0] for n in ("plain", "arms", "solo"))
    arm0 = all(torch.equal(arms["params"][0][k], v) for k, v in plain["params"].items())
    arm1 = all(torch.equal(arms["params"][1][k], v) for k, v in solo["params"][0].items())
    differ = not all(torch.equal(arms["params"][0][k], v) for k, v in arms["params"][1].items())
    rep = {n: runs[n][4] for n in ("arms", "solo")}
    rows = ROWS[strategy]
    times = all(rep["arms"].get(k, 0) == E * rep["solo"].get(k, 0) > 0 for k in rows)
    fetches = {n: runs[n][5] for n in ("plain", "arms", "solo")}
    plain_s = sum(r["seconds"] + (r.get("eval_seconds") or 0.0) for r in plain["history"])
    arms_s, solo_s = runs["arms"][1].dispatch_seconds[-1], runs["solo"][1].dispatch_seconds[-1]
    ok = arm0 and arm1 and differ and times and all(n == ARMS_ROUNDS // SS_ROUNDS
                                                    for n in fetches.values())
    msg = ""
    if strategy == "masked":
        resumed = runs["resumed"][0]
        resid = arms["wire_resid"]
        res_same = all(torch.equal(resumed["params"][e][k], v) for e in range(E)
                       for k, v in arms["params"][e].items()) \
            and np.array_equal(resumed["wire_resid"], resid)
        resid_arm = np.array_equal(resid[0], plain["wire_resid"]) and np.array_equal(
            resid[1], solo["wire_resid"][0])
        quant = (runs["arms"][3]["quant_pack"], runs["resumed"][3]["quant_pack"])
        ok = ok and res_same and resid_arm and resid.shape == (E, 1, plain["wire_resid"].size) \
            and quant == (E * ARMS_ROUNDS, E)
        msg = (f"; residuals {resid.shape}, arm 0 == plain and arm 1 == solo {resid_arm}; "
               f"quant_pack {quant[0]} (E={E}, {ARMS_ROUNDS} rounds), {quant[1]} (round 2 "
               f"resumed); round 2 resumed == uninterrupted (params, residuals) {res_same}")
    say(f"arms {strategy}: runs {runs['plain'][2]:.1f} s plain, {runs['arms'][2]:.1f} s E=2, "
        f"{runs['solo'][2]:.1f} s solo (host clock); arm 0 == plain {arm0}, arm 1 == solo "
        f"{arm1}, arms differ {differ}; host_fetch calls {fetches}; replayed {rows}: arms "
        f"{[rep['arms'].get(k) for k in rows]}, solo {[rep['solo'].get(k) for k in rows]}; the "
        f"superstep (two rounds, an evaluation, its captures) E=2 {arms_s:.4f} s, plain "
        f"{plain_s:.4f} s + solo {solo_s:.4f} s = {plain_s + solo_s:.4f} s (device clock); "
        f"captures and graph pools: " + ", ".join(
            f"{n} {runs[n][6]['captures']} / {runs[n][6]['pool_bytes'] / 2 ** 20:.1f} MB"
            for n in ("plain", "arms", "solo")) + msg)
    if not ok:
        raise AssertionError(f"arms {strategy}: an arm is not its solo run, a superstep fetched "
                             f"more than once, the launches are not E times the solo run's, or "
                             f"the resumed arms are not the uninterrupted ones")
    return {f"arms_{strategy}": (runs["arms"][3], rep["arms"]),
            f"arms_{strategy}_solo": (runs["solo"][3], rep["solo"])}


def drill_path(torch, counters, out_dir: str):
    """Phase 13d: ``chaos.drill`` on the card at the headline's full width
    (``ARMS_SIZES``, evaluated after the last round): masked,
    ``DRILL_MASKED`` (kills at a superstep, a fetch and a checkpoint write;
    the resumes capture their steps anew) over ``DRILL_ROUNDS`` rounds in
    supersteps of two; a prefetch kill under ``client_store='stream'``
    against the masked plan's uninterrupted run (a streamed run equals the
    eager one bit for bit, phase 11); grouped, ``DRILL_GROUPED`` over
    ``DRILL_GROUPED_ROUNDS`` rounds at K=1 -- a kill before the third
    checkpoint write, the live blob corrupted (the resume falls back a
    generation with the warning), then kills at a dispatch and a fetch;
    each resumed run equal to the uninterrupted one bit for bit; the
    poison drill in ``quarantine`` and ``rollback`` -> {path: (launches,
    replayed)}."""
    from heterofl_tpu_torch.chaos import resolve_fault_plan
    from heterofl_tpu_torch.chaos.drill import reference_params, run_kill_drill, run_poison_drill
    from heterofl_tpu_torch.parallel import step_graph

    kw = {"device": "cuda", "control": HEADLINE, "data_name": "CIFAR10",
          "model_name": "resnet18", "sizes": ARMS_SIZES}

    def over(rounds, **more):
        return {"num_epochs": {"global": rounds, "local": 1}, "pallas_norm": True,
                "eval_interval": rounds, "batch_size": {"train": BATCH, "test": 50}, **more}

    out = {}
    zero(counters)
    step_graph.reset_stats()
    masked_ref = reference_params(over(DRILL_ROUNDS), os.path.join(out_dir, "masked"), **kw)
    cases = (("drill_masked", DRILL_MASKED, over(DRILL_ROUNDS), masked_ref),
             ("drill_stream_prefetch", {"kills": [{"point": "prefetch", "at": 2}]},
              over(DRILL_ROUNDS, client_store="stream"), masked_ref),
             ("drill_grouped", DRILL_GROUPED,
              over(DRILL_GROUPED_ROUNDS, strategy="grouped", superstep_rounds=1), None),
             ("drill_quarantine", "quarantine", over(DRILL_POISON_ROUNDS), None),
             ("drill_rollback", "rollback", over(DRILL_POISON_ROUNDS), None))
    for path, plan, cfg_over, ref in cases:
        if path != "drill_masked":  # the masked plan's count takes in its reference run
            zero(counters)
            step_graph.reset_stats()
        root = os.path.join(out_dir, path)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if isinstance(plan, dict):
                rep = run_kill_drill(resolve_fault_plan(plan), cfg_over, root, reference=ref,
                                     **kw)
            else:
                rep = run_poison_drill(plan, cfg_over, root, **kw)
        torch.cuda.synchronize()
        rep["fallback_warnings"] = sum("checkpoint-corrupt" in str(w.message) for w in caught)
        say(f"{path}: " + json.dumps({k: v for k, v in rep.items() if k != "plan"}))
        corrupt = path != "drill_grouped" or (rep["corruptions"] and rep["fallback_warnings"])
        if not (rep["ok"] and corrupt):
            raise AssertionError(f"{path}: the drill's contract does not hold: {rep}")
        out[path] = (read(counters), dict(step_graph.REPLAYED))
    return out


# --- the model profile and the runtime audit --------------------------------------

#: phase 14's models: the headline ResNet-18, the MNIST conv twin, the
#: transformer (synthetic WikiText2's 512-token vocabulary)
PROFILE_MODELS = (("resnet18", "CIFAR10"), ("conv", "MNIST"), ("transformer", "WikiText2"))
FLOP_RATE_REPLAYS = 50  # replays of the level-a step timed for its FLOP rate


def profile_cfg(model_name: str, data_name: str):
    """The headline control at full width for ``model_name`` on
    ``data_name``, the BN kernels on, with the dataset's fields set."""
    from heterofl_tpu_torch import config as C

    if model_name == "transformer":
        return lm_cfg()
    cfg = C.default_cfg()
    cfg.update(control=C.parse_control_name(HEADLINE), model_name=model_name,
               data_name=data_name, pallas_norm=True)
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def profile_phase(torch, out_dir: str) -> dict:
    """(a) ``analysis.summary.make_summary`` at full width on the card for
    each of :data:`PROFILE_MODELS`, levels a-e: ``num_params`` equal to the
    CPU's ``fed.core.level_param_table``, the forward's FLOPs
    (``FlopCounterMode``) on the card equal to the same count on the CPU;
    each level's params, training FLOPs a step (``level_flop_table``) and
    wire bytes a round (dense and int8, ``level_codec_byte_table``)
    printed -> ``{model: {level: row}}``."""
    from heterofl_tpu_torch.analysis.summary import make_summary, profile_model
    from heterofl_tpu_torch.fed.core import (level_codec_byte_table, level_flop_table,
                                             level_param_table)

    out = {}
    for model_name, data_name in PROFILE_MODELS:
        cfg = dict(profile_cfg(model_name, data_name), output_dir=out_dir)
        summ = make_summary(cfg, rates=list(LEVELS), device="cuda")
        params, flops = level_param_table(cfg, LEVELS), level_flop_table(cfg, LEVELS)
        dense, int8 = (level_codec_byte_table(cfg, c, LEVELS) for c in ("dense", "int8"))
        rows = {}
        for mode, rate, n, fwd, _mb in summ["rows"]:
            cpu = profile_model(cfg, rate, device="cpu")
            src = summ["results"][mode]["flops_source"]
            if n != params[rate] or fwd != cpu["num_flops"] or src != "torch_flop_counter":
                raise AssertionError(f"profile {model_name} level {mode}: params {n} against the "
                                     f"table's {params[rate]}, forward FLOPs {fwd} on the card "
                                     f"against {cpu['num_flops']} on the CPU ({src})")
            rows[mode] = {"params": n, "forward_flops": fwd, "step_flops": flops[rate],
                          "wire_dense": dense[rate], "wire_int8": int8[rate]}
            say(f"profile {model_name} level {mode} (rate {rate:g}): {n:,} params, forward "
                f"{fwd:.6e} FLOPs at batch {cfg['batch_size']['train']} (card == CPU), a "
                f"training step {flops[rate]:.6e} FLOPs (level_flop_table), wire a round "
                f"{dense[rate]:,} B dense, {int8[rate]:,} B int8")
        out[model_name] = rows
    return out


def audit_phase(torch, counters, out_path: str):
    """(b) ``python -m heterofl_tpu_torch.staticcheck --device cuda
    --flagship --diff-baseline`` in-process: zero findings and no ratchet
    regression against ``baseline.json``'s ``cuda`` section; each
    program's launches a replayed step, captures, graph pool and peak MB
    and wire bytes printed; every kernel of rows 1-4 and 1b-3b launched ->
    ``(launches, replayed, report)``."""
    from heterofl_tpu_torch.parallel import step_graph
    from heterofl_tpu_torch.staticcheck.__main__ import main as staticcheck

    zero(counters)
    step_graph.reset_stats()
    rc = staticcheck(["--device", "cuda", "--flagship", "--diff-baseline", "--out", out_path])
    torch.cuda.synchronize()
    launches, replayed = read(counters), dict(step_graph.REPLAYED)
    with open(out_path) as f:
        report = json.load(f)
    for name, p in report["programs"].items():
        mem = p.get("memory") or {}
        say(f"audit {name}: launches a replayed step {p['launches']}; graphs {p['graphs']}, "
            f"captures {p['captures']}, recompile {p['recompile']}; host_fetch "
            f"{p['host_fetches']}; wire by level {p['wire']['levels']} (table sum "
            f"{p['wire']['level_bytes']:,} B); peak {mem.get('peak_mb')} MB, pool {mem.get('pool_mb')} MB "
            f"(ceilings {mem['budget']['peak_budget'] / 2 ** 20:.1f} / "
            f"{mem['budget']['pool_budget'] / 2 ** 20:.1f} MB)")
    fb = report["flop_budget"]
    say(f"audit FLOP shares (tol {fb['tol']}): measured {fb['measured_shares']}, analytic "
        f"{fb['analytic_shares']}; wire frontier {report['wire_frontier']}")
    say(f"audit: launches {launches}; ratchet {json.dumps(report['ratchet'])[:2000]}")
    if rc != 0:
        raise AssertionError(f"staticcheck --device cuda --flagship --diff-baseline exited {rc}: "
                             f"{[f for p in report['programs'].values() for f in p['findings']]}"
                             f" {report['flop_budget'].get('findings')} {report['lint']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"audit: a kernel never launched under the audit: {launches}")
    return launches, replayed, report


def flop_rate_phase(torch) -> dict:
    """(d) A replayed masked level-a step of the headline at full width:
    ``level_flop_table[a]`` over its device ms (CUDA events around
    :data:`FLOP_RATE_REPLAYS` replays, the step counter reset before each)
    -- a number for PERF.md, not a metric."""
    from heterofl_tpu_torch.entry.common import FedExperiment
    from heterofl_tpu_torch.fed.core import level_flop_table
    from heterofl_tpu_torch.staticcheck.audit import default_audit_cfg

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rate_") as tmp:
        cfg = default_audit_cfg(True, "cuda", output_dir=tmp, superstep_rounds=2)
        exp = FedExperiment(cfg, 0)
        exp.stage(*exp.make_splits())
        eng = exp.engine
        P = eng.flatten(exp.model.params())
        step, st = eng.client_step(1.0, P, exp.train_data)
        eng.stage_client(st, P, 1.0, 0, exp.train_data, 1)
        for _ in range(3):
            st["t"].zero_()
            step.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FLOP_RATE_REPLAYS):
            st["t"].zero_()
            step.replay()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / FLOP_RATE_REPLAYS
        flops = level_flop_table(exp.cfg, [1.0])[1.0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rate = flops / (ms * 1e-3)
    say(f"FLOP rate: a replayed masked level-a headline step (batch {cfg['batch_size']['train']})"
        f" {ms:.4f} ms on the device clock, {flops:.6e} FLOPs (level_flop_table), "
        f"{rate / 1e12:.3f} TFLOP/s on {smi}")
    return {"step_ms": ms, "step_flops": flops, "tflops": rate / 1e12, "card": smi}


def process_phase(tmp: str) -> dict:
    """(c) ``analysis.process`` over the result bundles the earlier phases'
    test entries wrote (every ``<tmp>/*/result/*.pkl``): each directory's
    rows aggregated and its csv written; each aggregate's mean equal to
    the bundle's logged metric, and the csv holding it -> ``{dir: rows}``."""
    import glob
    import pickle

    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.analysis import process

    dirs = sorted({os.path.dirname(os.path.dirname(p))
                   for p in glob.glob(os.path.join(tmp, "*", "result", "*.pkl"))})
    out = {}
    for d in dirs:
        rows = process.load_results(d)
        agg = process.aggregate(rows)
        csv_path = process.export_table(agg, d)
        with open(csv_path) as f:
            csv = f.read()
        for r in rows:
            with open(os.path.join(d, "result", f"{r['tag']}.pkl"), "rb") as f:
                bundle = pickle.load(f)
            hist = bundle.get("logger_history", {})
            logged = {k: float(v[-1]) for k, v in ((k[5:], v) for k, v in hist.items()
                                                   if k.startswith("test/")) if v}
            logged.update({k: float(v) for k, v in bundle.get("metrics", {}).items()})
            key = "_".join([r["data_name"], r["subset"], r["model_name"]]
                           + [r[k] for k in C.CONTROL_KEYS])
            mean = agg[key]["mean"]
            bad = {m: (mean.get(m), logged[m]) for m in mean if mean[m] != logged.get(m)}
            if not mean or bad or agg[key]["n_seeds"] != 1:
                raise AssertionError(f"process {d}: aggregate {mean} against the bundle's "
                                     f"logged {logged}: {bad}")
            if not all(f"{v:.6g}" in csv for v in mean.values()):
                raise AssertionError(f"process {d}: the csv lacks {mean}")
            say(f"process {os.path.basename(d)}: {r['tag']} aggregated {mean} == logged "
                f"(n_seeds 1) -> {csv_path}")
        out[d] = len(rows)
    if not out:
        raise AssertionError("process: no result bundle from the earlier phases")
    return out


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


def mesh_argv(out_dir: str, codec: str, k: int):
    """Phase 15's headline flags: ``MESH_SIZES``, ``MESH_ROUNDS`` rounds of
    one local epoch, K=1 or one superstep, evaluated after the last."""
    return ["--control_name", HEADLINE, "--synthetic", "1", "--synthetic_sizes",
            json.dumps(MESH_SIZES), "--pallas_norm", "1", "--fused_update", "1",
            "--wire_codec", codec, "--superstep_rounds", str(k),
            "--eval_interval", str(MESH_ROUNDS), "--output_dir", out_dir,
            "--override", json.dumps({"num_epochs": {"global": MESH_ROUNDS, "local": 1}})]


def all_reduce_timing(torch, spec, P) -> dict:
    """Phase 15b, inside the one-rank NCCL group: the round's one
    all-reduce at the flagship's dense payload and its int8 payload, timed
    on CUDA events through ``Mesh.all_reduce_sum`` (the pack into one
    buffer included) and bare (``dist.all_reduce`` of the packed buffer),
    with the bytes each moves; the kernels a bare dense all-reduce runs,
    by name, from a profiler trace."""
    import torch.distributed as dist

    from heterofl_tpu_torch.compress import make_codec
    from heterofl_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(0, device=torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = spec.total
    summed = torch.randn(n, generator=gen, device="cuda")
    counts = torch.randint(0, 11, (n,), generator=gen, device="cuda").to(torch.float32)
    codec = make_codec("int8", spec, mesh.size)
    resid = torch.zeros((1, n), device="cuda")
    noise = torch.rand(n, generator=gen, device="cuda")
    payload, _ = codec.encode(summed, counts, resid, P, noise, 10)
    out = {}
    for name, tensors in (("dense", [summed, counts]), ("int8", list(payload.values()))):
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        buf = torch.cat([t.reshape(-1) for t in tensors])
        wrap = time_ms(lambda: mesh.all_reduce_sum(tensors))
        bare = time_ms(lambda: dist.all_reduce(buf))
        out[name] = {"bytes": nbytes, "wrapper_ms": wrap, "bare_ms": bare,
                     "shapes": [list(t.shape) for t in tensors],
                     "dtypes": sorted({str(t.dtype) for t in tensors})}
        say(f"mesh: the round's all-reduce, {name} payload {[list(t.shape) for t in tensors]} "
            f"{out[name]['dtypes']} = {nbytes:,} bytes: {wrap:.4f} ms through the wrapper (the "
            f"pack included), {bare:.4f} ms bare (CUDA events, one-rank NCCL group)")
    buf = torch.cat([summed, counts])
    prof, _ = trace(lambda: dist.all_reduce(buf))
    names = sorted({e for e in device_events(prof)})
    out["dense"]["trace_device_names"] = names
    say(f"mesh: a bare dense all-reduce on one NCCL rank ran on the card: "
        f"{names or 'nothing (no kernel, no copy)'}")
    return out


def mesh_name(codec: str, k: int) -> str:
    return f"mesh_{'k1' if k == 1 else 'superstep'}_{codec}"


def flat_params(params):
    """An entry result's params, host float32, concatenated in sorted-key
    order."""
    import numpy as np

    return np.concatenate([params[n].detach().cpu().numpy().ravel() for n in sorted(params)])


def mesh_collectives_ok(colls: dict, k: int) -> bool:
    """One all-reduce a round and one an sBN and a Global pass; one gather a
    round's (K=1) or a superstep's rows and one a Local pass."""
    return colls["all_reduce"] == MESH_ROUNDS + 2 and \
        colls["gather"] == (MESH_ROUNDS if k == 1 else 1) + 1


def mesh_rank_main(torch, out_dir: str, backend: str) -> None:
    """One rank of phase 15c (``chip_smoke.py --mesh-rank OUT_DIR``, started
    with torchrun's variables by ``parallel/pod.py::_spawn``): joins the
    ``backend`` group on the card, runs the headline entry at each of
    ``MESH_RUNS`` as every rank runs it under torchrun (one output
    directory, a shard a rank), each run's collectives and launches counted
    from 0, then the pod probe's rank (``pod.child_main``, which leaves the
    group).  Writes each run's params as ``<run>_rank<r>.npy`` and
    ``mesh_rank<r>.json``."""
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.ops import fused_norm, fused_update, quant
    from heterofl_tpu_torch.parallel import mesh as M
    from heterofl_tpu_torch.parallel import pod

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    if not M.initialize_distributed(backend, "cuda"):
        raise AssertionError("mesh rank: started without torchrun's variables")
    rank = dist.get_rank()
    counters = (fused_norm.LAUNCHES, fused_update.LAUNCHES, quant.LAUNCHES)
    out = {"rank": rank, "backend": dist.get_backend()}
    for codec, k in MESH_RUNS:
        what = mesh_name(codec, k)
        M.reset_counts()
        res, secs, launches, _ = counted_run(
            torch, counters, train_classifier_fed.main,
            mesh_argv(os.path.join(out_dir, "entry", what), codec, k), f"mesh rank {rank}: {what}")
        np.save(os.path.join(out_dir, f"{what}_rank{rank}.npy"), flat_params(res["params"]))
        resid = res["wire_resid"]
        out[what] = {"seconds": secs, "collectives": dict(M.COLLECTIVES), "launches": launches,
                     "loss": [h["loss"] for h in res["history"]],
                     "resid_sha256": None if resid is None else hashlib.sha256(
                         np.ascontiguousarray(resid).tobytes()).hexdigest()}
    pod.child_main(os.path.join(out_dir, "probe"), backend=backend, device="cuda",
                   engine="masked")
    with open(os.path.join(out_dir, f"mesh_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def mesh_ranks_check(torch, out_dir: str, plain_flat: dict, plain_loss: dict) -> dict:
    """Phase 15c: ``MESH_RANKS`` ranks on the card (gloo sharing one GPU;
    NCCL across two where the machine has them), each running
    :func:`mesh_rank_main`; then the probe alone in this process.  Holds
    every run's ranks bit for bit equal (params and logged losses), the
    dense runs' params within ``RANKS_ATOL`` of the one-rank run's, the
    int8 runs' residual rows apart (each rank's own noise), each rank's
    collectives one all-reduce a round, and the probe as
    ``pod.compare_probes`` does -> numbers and each rank's launches."""
    import numpy as np

    from heterofl_tpu_torch.parallel import pod

    gpus = torch.cuda.device_count()
    backend = "nccl" if gpus >= MESH_RANKS else "gloo"
    t0 = time.time()
    pod._spawn([sys.executable, os.path.abspath(__file__), "--mesh-rank", out_dir,
                "--mesh-backend", backend], MESH_RANKS, MESH_RANK_TIMEOUT, gpus)
    spawn_s = time.time() - t0
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"mesh_rank{r}.json")) as f:
            ranks.append(json.load(f))
    nums = {"backend": backend, "spawn_s": spawn_s, "runs": {}}
    launches = {}
    for codec, k in MESH_RUNS:
        what = mesh_name(codec, k)
        flats = [np.load(os.path.join(out_dir, f"{what}_rank{r}.npy")) for r in range(MESH_RANKS)]
        equal = all(np.array_equal(f, flats[0]) for f in flats[1:]) and \
            all(rk[what]["loss"] == ranks[0][what]["loss"] for rk in ranks)
        diff = float(np.max(np.abs(flats[0].astype(np.float64) - plain_flat[what])))
        run = {"ranks_equal": equal, "vs_one_rank": diff,
               "finite": bool(np.isfinite(flats[0]).all()),
               "seconds": [rk[what]["seconds"] for rk in ranks],
               "collectives": [rk[what]["collectives"] for rk in ranks],
               "loss": ranks[0][what]["loss"], "loss_one_rank": plain_loss[what]}
        nums["runs"][what] = run
        say(f"mesh: {what} at {MESH_RANKS} {backend} ranks on the card through the entry: ranks "
            f"equal bit for bit {equal}, max |params - one rank| {diff:.3e}, losses "
            f"{run['loss']} (one rank {plain_loss[what]}), seconds {run['seconds']}, "
            f"collectives {run['collectives']}")
        bad = [f"rank {rk['rank']} collectives {rk[what]['collectives']}" for rk in ranks
               if not mesh_collectives_ok(rk[what]["collectives"], k)]
        for rk in ranks:
            n = rk[what]["launches"]
            launches[f"{what}_{MESH_RANKS}ranks_rank{rk['rank']}"] = n
            if n["fused_sgd"] <= 0 or n["bn_fwd"] <= 0 or \
                    (n["quant_pack"] > 0) != (codec == "int8"):
                bad.append(f"rank {rk['rank']} launches {n}")
        if not (equal and run["finite"]):
            bad.append("the ranks' params or losses differ, or are not finite")
        if codec == "dense" and not diff <= pod.RANKS_ATOL:
            bad.append(f"params {diff:.3e} from the one-rank run (RANKS_ATOL {pod.RANKS_ATOL})")
        if codec == "int8" and len({rk[what]["resid_sha256"] for rk in ranks}) != MESH_RANKS:
            bad.append("the ranks' residual rows are equal (each rank's own noise expected)")
        if bad:
            raise AssertionError(f"mesh: {what} at {MESH_RANKS} ranks: {bad}")
    many, one = os.path.join(out_dir, "probe"), os.path.join(out_dir, "probe_one")
    res = []
    for r in range(MESH_RANKS):
        with open(os.path.join(many, f"pod_result_p{r}.json")) as f:
            res.append(json.load(f))
    threads = torch.get_num_threads()
    try:
        res1 = pod.child_main(one, device="cuda", engine="masked")  # the probe alone, here
    finally:
        torch.set_num_threads(threads)
    probe = pod.compare_probes(many, res, one, [res1])
    nums["probe"] = probe
    for r, rr in enumerate(res):
        launches[f"mesh_probe_rank{r}"] = rr["launches"]
    return {"nums": nums, "launches": launches, "ranks": ranks}


def mesh_phase(torch, counters, out_dir: str, spec, P):
    """Phase 15 (the module docstring) -> ({path: launches}, {path:
    replayed launches}, numbers)."""
    import torch.distributed as dist

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.parallel import mesh as M
    from heterofl_tpu_torch.parallel.pod import RANKS_ATOL, _free_port

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs, name = MESH_RUNS, mesh_name
    plain, launches, replayed, nums = {}, {}, {}, {}
    try:
        for codec, k in runs:
            plain[name(codec, k)], _, _, _ = counted_run(
                torch, counters, train_classifier_fed.main,
                mesh_argv(os.path.join(out_dir, "plain", name(codec, k)), codec, k),
                f"mesh: {name(codec, k)} without a process group")
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())}
        saved = {v: os.environ.get(v) for v in env}
        os.environ.update(env)
        try:
            if not M.initialize_distributed(device="cuda") or dist.get_backend() != "nccl":
                raise AssertionError("mesh: no one-rank NCCL group joined")
            for codec, k in runs:
                what = name(codec, k)
                M.reset_counts()
                res, secs, launches[what], replayed[what] = counted_run(
                    torch, counters, train_classifier_fed.main,
                    mesh_argv(os.path.join(out_dir, "nccl", what), codec, k),
                    f"mesh: {what} as rank 0 of a one-rank NCCL group")
                colls = dict(M.COLLECTIVES)
                say(f"mesh: {what}: {secs:.1f} s, collectives {colls}; launches "
                    f"{launches[what]}")
                if not mesh_collectives_ok(colls, k):
                    raise AssertionError(f"mesh: {what} made collectives {colls}")
                if not same_run(torch, res, plain[what]):
                    raise AssertionError(f"mesh: {what} under the one-rank NCCL group is not "
                                         f"the run without a group bit for bit")
                if launches[what]["fused_sgd"] <= 0 or launches[what]["bn_fwd"] <= 0 or \
                        (launches[what]["quant_pack"] > 0) != (codec == "int8"):
                    raise AssertionError(f"mesh: {what}: launches {launches[what]}")
                say(f"mesh: {what} under the one-rank NCCL group equals the run without a "
                    f"group bit for bit (cohorts, logs, params, residual)")
            nums["all_reduce"] = all_reduce_timing(torch, spec, P)
        finally:
            M.shutdown_distributed()
            for v, old in saved.items():
                if old is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = old
        plain_flat = {w: flat_params(r["params"]) for w, r in plain.items()}
        plain_loss = {w: [h["loss"] for h in r["history"]] for w, r in plain.items()}
        del plain
        torch.cuda.empty_cache()
        two = mesh_ranks_check(torch, os.path.join(out_dir, "ranks"), plain_flat, plain_loss)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    launches.update(two["launches"])
    probe, backend = two["nums"]["probe"], two["nums"]["backend"]
    r2, r1 = probe["results"], probe["one_rank"][0]
    say(f"mesh: the two-rank spawn (the entry at {len(MESH_RUNS)} settings, then the probe) "
        f"took {two['nums']['spawn_s']:.1f} s")
    say(f"mesh: the pod probe at two {backend} ranks: ranks equal bit for bit "
        f"{probe['ranks_equal']}, against one rank {probe['vs_one_rank']} (params within "
        f"{RANKS_ATOL}: {probe['within_tolerance']}), all-reduces a round "
        f"{probe['all_reduce_per_round']}, sharded checkpoint read back "
        f"{probe['sharded_ckpt_ok']}; round seconds (host clock) "
        f"{[r['superstep_s'] / r['k'] for r in r2]} at two ranks, {r1['superstep_s'] / r1['k']} "
        f"at one; gloo all-reduces a CUDA tensor itself: "
        f"{[r.get('gloo_cuda_direct') for r in r2]}; foreign modules "
        f"{[r['foreign_modules'] for r in r2]}")
    if not (probe["ranks_equal"] and probe["within_tolerance"] and probe["sharded_ckpt_ok"]
            and all(x == 1 for x in probe["all_reduce_per_round"])
            and not any(r["foreign_modules"] for r in r2)):
        raise AssertionError(f"mesh: the pod probe failed: "
                             f"{ {k: v for k, v in probe.items() if k != 'one_rank'} }")
    say(f"mesh: the probe's launches a rank over its two supersteps: "
        f"{[res['launches'] for res in r2]}; one rank {r1['launches']}")
    nums["probe"] = {"backend": backend, "vs_one_rank": probe["vs_one_rank"],
                     "round_s_two": [r["superstep_s"] / r["k"] for r in r2],
                     "round_s_one": r1["superstep_s"] / r1["k"],
                     "gloo_cuda_direct": [r.get("gloo_cuda_direct") for r in r2]}
    nums["ranks"] = {w: {k: v for k, v in run.items() if k != "loss_one_rank"}
                     for w, run in two["nums"]["runs"].items()}
    # the one-rank runs, which phase 17 holds its (1, 2) runs against
    nums["one_rank"] = {w: (plain_flat[w], plain_loss[w]) for w in plain_flat}
    return launches, replayed, nums


# --- phase 16: the grouped engine on the clients mesh axis ------------------------------

#: phase 16c's two-level control: level a on rank 0, level b on rank 1
GMESH_SLICES = "1_100_0.1_iid_fix_a1-b1_bn_1_1"
#: phase 16a's one-rank runs of the grouped headline: (name, codec, K)
GMESH_RUNS = (("k1_dense", "dense", 1), ("superstep_dense", "dense", MESH_ROUNDS),
              ("superstep_map", json.dumps(CODEC_MAP), MESH_ROUNDS))
#: phase 16d: the map's entry over two supersteps, uninterrupted and cut after one
GMESH_MAP_ROUNDS = 2 * MESH_ROUNDS
GMESH_ALL_REDUCE_CALLS = 3  # timed calls of each payload's all-reduce on each rank
BATCHED = ("bn_fwd_batched", "bn_bwd_batched", "fused_sgd_batched")
ONE_CLIENT = ("bn_fwd", "bn_bwd", "fused_sgd")


def gmesh_argv(out_dir: str, codec: str, k: int, rounds: int = MESH_ROUNDS,
               control: str = HEADLINE, *extra):
    """Phase 16's flags: :func:`mesh_argv`'s with ``--strategy grouped``,
    ``rounds`` rounds evaluated after the last, on ``control``."""
    argv = mesh_argv(out_dir, codec, k) + ["--strategy", "grouped", *extra]
    argv[argv.index("--control_name") + 1] = control
    argv[argv.index("--eval_interval") + 1] = str(rounds)
    argv[argv.index("--override") + 1] = json.dumps({"num_epochs": {"global": rounds,
                                                                    "local": 1}})
    return argv


def gmesh_collectives_ok(colls: dict, rounds: int, k: int) -> bool:
    """One all-reduce a round (the per-level map's payload too) and one an
    sBN and a Global pass of the one evaluation, after the last round; one
    gather a round's (K=1) or a superstep's rows and one a Local pass."""
    gathers = (rounds if k == 1 else rounds // k) + 1
    return colls["all_reduce"] == rounds + 2 and colls["gather"] == gathers


def rank_all_reduce_ms(torch, mesh, tensors, calls: int = GMESH_ALL_REDUCE_CALLS) -> float:
    """The median ms (CUDA events) of ``Mesh.all_reduce_sum`` of
    ``tensors`` on this rank over ``calls`` calls after one warm-up; every
    rank makes the same calls."""
    mesh.all_reduce_sum(tensors)
    times = []
    for _ in range(calls):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        mesh.all_reduce_sum(tensors)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gmesh_payloads(torch, device) -> dict:
    """The round's all-reduce payloads at two ranks on the headline:
    dense, the merged ``[2, n]`` float32 sums and counts; under
    ``CODEC_MAP``, every level's (a dense level's float32 sliced sums and
    counts, a lossy level's codec lanes at two participants), as the
    grouped engine's one all-reduce carries them."""
    from heterofl_tpu_torch import config as C
    from heterofl_tpu_torch.compress import make_codec, normalize_codec_map
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.ops.fused_update import FlatSpec

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(HEADLINE)
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    n = FlatSpec.of(dict(make_model(cfg).named_parameters())).total
    dense = [torch.zeros(n, device=device), torch.zeros(n, device=device)]
    payload = []
    for rate, name in sorted(normalize_codec_map(CODEC_MAP).items(), reverse=True):
        spec = FlatSpec.of(dict(make_model(cfg, rate).named_parameters()))
        if name == "dense":
            payload += [torch.zeros(spec.total, device=device)] * 2
        else:
            payload += list(make_codec(name, spec, MESH_RANKS).zero_payload(device).values())
    return {"dense": dense, "map": payload}


def gmesh_rank_main(torch, out_dir: str, backend: str) -> None:
    """One rank of phase 16 (``chip_smoke.py --gmesh-rank OUT_DIR``, started
    with torchrun's variables by ``parallel/pod.py::_spawn``): joins the
    ``backend`` group on the card and runs, each with its launches and
    collectives counted from 0: (b) the grouped headline superstep under
    ``span``, on rank 0 inside a profiler trace whose hand-written kernels
    must equal the counters (a trace that lost records is taken again, on
    every rank, up to ``TRACE_TRIES``); (c) ``GMESH_SLICES`` under
    ``slices`` with ``strict_placement``, each rank's trained levels
    recorded; (d) the entry under ``CODEC_MAP`` over ``GMESH_MAP_ROUNDS``
    rounds, uninterrupted, cut after one superstep and resumed; each
    payload's all-reduce timed; the grouped LM entry's one round (phase
    7's flags); (e) the grouped slices probe's rank, which leaves the
    group.  Writes each run's params as ``<run>_rank<r>.npy`` and
    ``gmesh_rank<r>.json``."""
    import hashlib

    import numpy as np

    from heterofl_tpu_torch.entry import train_classifier_fed, train_transformer_fed
    from heterofl_tpu_torch.ops import fused_norm, fused_update, quant
    from heterofl_tpu_torch.parallel import mesh as M
    from heterofl_tpu_torch.parallel import pod
    from heterofl_tpu_torch.parallel.grouped import GroupedRoundEngine
    from heterofl_tpu_torch.staticcheck.wire import ring_allreduce_bytes

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    if not M.initialize_distributed(backend, "cuda"):
        raise AssertionError("grouped mesh rank: started without torchrun's variables")
    mesh = M.make_mesh(0, device=torch.device("cuda"))
    rank = mesh.rank
    counters = (fused_norm.LAUNCHES, fused_update.LAUNCHES, quant.LAUNCHES)
    out = {"rank": rank, "backend": mesh.backend}
    trained, level_step = [], GroupedRoundEngine.level_step

    def recording(self, lv, G, *a, **k):  # the levels this rank's steps train
        trained.append(next(r for r, v in self.levels.items() if v is lv))
        return level_step(self, lv, G, *a, **k)

    def run(what, argv, traced=False):
        for attempt in range(1, TRACE_TRIES + 1):
            M.reset_counts()
            trained.clear()
            argv_a = list(argv)
            if traced:  # a fresh output directory each attempt
                i = argv_a.index("--output_dir") + 1
                argv_a[i] = f"{argv_a[i]}_{attempt}"
            holder = {}

            def go():
                holder["r"] = counted_run(torch, counters, train_classifier_fed.main, argv_a,
                                          f"grouped mesh rank {rank}: {what}")

            prof = trace(go)[0] if traced and rank == 0 else go()
            res, secs, launches, replayed = holder["r"]
            colls = dict(M.COLLECTIVES)
            coll_bytes = dict(M.COLLECTIVE_BYTES)
            got = traced_kernels(prof) if prof is not None else None
            ok = got is None or all(got[k] == launches.get(k, 0) for k in KERNEL_OF)
            if traced and not mesh.broadcast_int(int(ok)):
                if rank == 0 and any(got[k] > launches.get(k, 0) for k in KERNEL_OF):
                    raise AssertionError(f"{what}: the trace counted {got} kernels, more than "
                                         f"the launch counters' {launches}")
                say(f"{what}: trace {attempt} counted {got}, not the counters' {launches}")
                continue
            break
        else:
            raise AssertionError(f"{what}: no trace counted the launches {launches}")
        np.save(os.path.join(out_dir, f"{what}_rank{rank}.npy"), flat_params(res["params"]))
        resid = res["wire_resid"]
        rounds = len(res["history"])
        out[what] = {"seconds": secs, "round_s_host": secs / max(1, rounds),
                     "collectives": colls,
                     "payload_bytes_per_round": coll_bytes["all_reduce"],
                     "launches": launches, "replayed": replayed, "traced": got,
                     "trained_levels": sorted(set(trained), reverse=True),
                     "loss": [h["loss"] for h in res["history"]],
                     "epochs": [h["epoch"] for h in res["history"]],
                     "resid_sha256": None if resid is None else hashlib.sha256(
                         np.ascontiguousarray(resid).tobytes()).hexdigest()}
        say(f"grouped mesh rank {rank}: {what}: {secs:.1f} s, collectives {colls}, launches "
            f"{launches}, levels trained {out[what]['trained_levels']}")

    GroupedRoundEngine.level_step = recording
    try:
        run("span_superstep", gmesh_argv(os.path.join(out_dir, "entry", "span"), "dense",
                                         MESH_ROUNDS), traced=True)
        run("slices_superstep", gmesh_argv(
            os.path.join(out_dir, "entry", "slices"), "dense", MESH_ROUNDS, MESH_ROUNDS,
            GMESH_SLICES, "--level_placement", "slices", "--strict_placement", "1"))
        cmap = json.dumps(CODEC_MAP)
        for what, rounds, resume, sub in (("map_full", GMESH_MAP_ROUNDS, 0, "map_full"),
                                          ("map_part", MESH_ROUNDS, 0, "map_cut"),
                                          ("map_resumed", GMESH_MAP_ROUNDS, 1, "map_cut")):
            run(what, gmesh_argv(os.path.join(out_dir, "entry", sub), cmap, MESH_ROUNDS,
                                 rounds, HEADLINE, "--resume_mode", str(resume)))
    finally:
        GroupedRoundEngine.level_step = level_step
    # the grouped LM entry, one round (phase 7's flags): its one client on rank 0
    M.reset_counts()
    res, secs, launches, _ = counted_run(
        torch, counters, train_transformer_fed.main,
        lm_argv(os.path.join(out_dir, "entry", "grouped_lm"), 1, "--strategy", "grouped"),
        f"grouped mesh rank {rank}: the grouped LM entry")
    np.save(os.path.join(out_dir, f"grouped_lm_rank{rank}.npy"), flat_params(res["params"]))
    out["grouped_lm"] = {"seconds": secs, "launches": launches,
                         "collectives": dict(M.COLLECTIVES),
                         "loss": [h["loss"] for h in res["history"]]}
    del res
    timing = {}
    for name, tensors in gmesh_payloads(torch, mesh.device).items():
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        reduced = M.reduce_buffer_bytes(tensors)
        timing[name] = {"ms": rank_all_reduce_ms(torch, mesh, tensors), "payload_bytes": nbytes,
                        "reduced_bytes": reduced,
                        "ring_bytes": ring_allreduce_bytes(reduced, mesh.size)}
    out["all_reduce"] = timing
    pod.child_main(os.path.join(out_dir, "probe"), backend=backend, device="cuda",
                   engine="grouped")
    with open(os.path.join(out_dir, f"gmesh_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def gmesh_ranks_check(torch, out_dir: str, plain_flat: dict, lm_one_rank) -> dict:
    """Phase 16b-f: ``MESH_RANKS`` ranks on the card (gloo sharing one GPU;
    NCCL across two where the machine has them), each running
    :func:`gmesh_rank_main`; then the probe alone in this process.  Holds
    each run's ranks bit for bit equal, the span and slices supersteps
    within ``RANKS_ATOL`` of the one-rank span runs, one all-reduce a round
    on each rank, each rank's batched kernels (and no one-client kernel),
    under slices each rank training only its own level, the map's resumed
    run equal to the uninterrupted one bit for bit with residual rows
    apart, the grouped LM entry's round (level a on rank 0, rank 1's block
    empty) within ``RANKS_ATOL`` of phase 7's one-rank round
    (``lm_one_rank``) with 3b and no BN kernel launched, and the probe as
    ``pod.compare_probes`` does -> numbers and each rank's launches."""
    import numpy as np

    from heterofl_tpu_torch.parallel import pod

    gpus = torch.cuda.device_count()
    backend = "nccl" if gpus >= MESH_RANKS else "gloo"
    t0 = time.time()
    pod._spawn([sys.executable, os.path.abspath(__file__), "--gmesh-rank", out_dir,
                "--mesh-backend", backend], MESH_RANKS, MESH_RANK_TIMEOUT, gpus)
    spawn_s = time.time() - t0
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"gmesh_rank{r}.json")) as f:
            ranks.append(json.load(f))
    flats = {w: [np.load(os.path.join(out_dir, f"{w}_rank{r}.npy")) for r in range(MESH_RANKS)]
             for w in ("span_superstep", "slices_superstep", "map_full", "map_resumed")}
    nums = {"backend": backend, "spawn_s": spawn_s, "runs": {}}
    launches, bad = {}, []
    for what in ("span_superstep", "slices_superstep", "map_full", "map_part", "map_resumed"):
        recs = [rk[what] for rk in ranks]
        equal = all(rec["loss"] == recs[0]["loss"] for rec in recs) and (
            what not in flats or all(np.array_equal(f, flats[what][0]) for f in flats[what]))
        k_rounds = len(recs[0]["epochs"])
        for rk, rec in zip(ranks, recs):
            launches[f"gmesh_{what}_rank{rk['rank']}"] = rec["launches"]
            n = rec["launches"]
            if not gmesh_collectives_ok(rec["collectives"], k_rounds, MESH_ROUNDS):
                bad.append(f"{what} collectives {rec['collectives']}")
            if min(n[k] for k in BATCHED) <= 0 or any(n[k] for k in ONE_CLIENT) or \
                    (n["quant_pack"] > 0) != what.startswith("map"):
                bad.append(f"{what} launches {n}")
        if not equal:
            bad.append(f"{what}: the ranks' params or losses differ")
        run = {"ranks_equal": equal, "seconds": [r["seconds"] for r in recs],
               "round_s_host": [r["round_s_host"] for r in recs],
               "collectives": [r["collectives"] for r in recs],
               "payload_bytes": [r["payload_bytes_per_round"] for r in recs],
               "levels": [r["trained_levels"] for r in recs], "loss": recs[0]["loss"]}
        ref = {"span_superstep": "superstep_dense", "slices_superstep": "slices_span"}.get(what)
        if ref is not None:
            run["vs_one_rank"] = float(np.max(np.abs(flats[what][0].astype(np.float64)
                                                     - plain_flat[ref])))
            if not run["vs_one_rank"] <= pod.RANKS_ATOL:
                bad.append(f"{what}: params {run['vs_one_rank']:.3e} from the one-rank span run")
        nums["runs"][what] = run
        say(f"grouped mesh: {what} at {MESH_RANKS} {backend} ranks: ranks equal {equal}, "
            f"levels trained a rank {run['levels']}, against one rank "
            f"{run.get('vs_one_rank')}, losses {run['loss']}, seconds {run['seconds']} "
            f"(host clock; a round {run['round_s_host']}), collectives {run['collectives']}, "
            f"all-reduce payload bytes a run {run['payload_bytes']}")
    span = ranks[0]["span_superstep"]
    say(f"grouped mesh: span superstep on rank 0: launch counters {span['launches']}, the "
        f"profiler trace's kernels {span['traced']}")
    lm_flats = [np.load(os.path.join(out_dir, f"grouped_lm_rank{r}.npy"))
                for r in range(MESH_RANKS)]
    d_lm = float(np.max(np.abs(lm_flats[0].astype(np.float64) - lm_one_rank)))
    lm_runs = [rk["grouped_lm"] for rk in ranks]
    nums["grouped_lm"] = {"vs_one_rank": d_lm, "loss": [r["loss"] for r in lm_runs],
                          "seconds": [r["seconds"] for r in lm_runs],
                          "collectives": [r["collectives"] for r in lm_runs]}
    say(f"grouped mesh: the grouped LM entry's round at {MESH_RANKS} {backend} ranks: ranks "
        f"equal {all(np.array_equal(f, lm_flats[0]) for f in lm_flats)}, against phase 7's "
        f"one-rank round {d_lm:.3e} (tolerance {pod.RANKS_ATOL:g}); {json.dumps(nums['grouped_lm'])}")
    for rk, rec in zip(ranks, lm_runs):
        launches[f"gmesh_grouped_lm_rank{rk['rank']}"] = n = rec["launches"]
        if any(n[k] for k in ("bn_fwd", "bn_bwd", "bn_fwd_batched", "bn_bwd_batched",
                              "fused_sgd", "quant_pack")) or \
                (n["fused_sgd_batched"] > 0) != (rk["rank"] == 0) or \
                rec["collectives"]["all_reduce"] < 1:
            bad.append(f"grouped LM rank {rk['rank']}: launches {n}, {rec['collectives']}")
    if not (all(np.array_equal(f, lm_flats[0]) for f in lm_flats) and d_lm <= pod.RANKS_ATOL
            and np.isfinite(lm_flats[0]).all()):
        bad.append(f"grouped LM at {MESH_RANKS} ranks: {nums['grouped_lm']}")
    levels = [rk["slices_superstep"]["trained_levels"] for rk in ranks]
    if levels != [[1.0], [0.5]]:
        bad.append(f"slices: the ranks trained levels {levels}, not [[1.0], [0.5]]")
    full, res = flats["map_full"], flats["map_resumed"]
    same = all(np.array_equal(a, b) for a, b in zip(full, res)) and all(
        rk["map_full"]["resid_sha256"] == rk["map_resumed"]["resid_sha256"]
        and rk["map_full"]["loss"][MESH_ROUNDS:] == rk["map_resumed"]["loss"] for rk in ranks)
    apart = len({rk["map_full"]["resid_sha256"] for rk in ranks}) == MESH_RANKS
    nums["map_resumed_equal"], nums["map_resid_rows_apart"] = same, apart
    say(f"grouped mesh: the map's entry resumed at the superstep boundary == uninterrupted "
        f"(params, residual rows, losses) {same}; the ranks' residual rows apart {apart}")
    if not (same and apart):
        bad.append("the map's resumed run is not the uninterrupted one, or the ranks' rows match")
    nums["all_reduce"] = [rk["all_reduce"] for rk in ranks]
    for rk in ranks:
        for name, t in rk["all_reduce"].items():
            say(f"grouped mesh: rank {rk['rank']}: the round's all-reduce, {name} payload "
                f"{t['payload_bytes']:,} bytes ({t['reduced_bytes']:,} as reduced; ring "
                f"{t['ring_bytes']:,} bytes a rank): {t['ms']:.4f} ms (CUDA events, through the "
                f"wrapper, {backend})")
    many, one = os.path.join(out_dir, "probe"), os.path.join(out_dir, "probe_one")
    pres = []
    for r in range(MESH_RANKS):
        with open(os.path.join(many, f"pod_result_p{r}.json")) as f:
            pres.append(json.load(f))
    threads = torch.get_num_threads()
    try:
        res1 = pod.child_main(one, device="cuda", engine="grouped")  # alone, here
    finally:
        torch.set_num_threads(threads)
    probe = pod.compare_probes(many, pres, one, [res1])
    nums["probe"] = {k: v for k, v in probe.items() if k not in ("results", "one_rank")}
    say(f"grouped mesh: the grouped slices probe at two {backend} ranks: "
        f"{json.dumps(nums['probe'])}; round seconds (host clock) "
        f"{[r['superstep_s'] / r['k'] for r in pres]} at two ranks, "
        f"{res1['superstep_s'] / res1['k']} at one (span)")
    for r, rr in enumerate(pres):
        launches[f"gmesh_probe_rank{r}"] = rr["launches"]
    if not (probe["ranks_equal"] and probe["within_tolerance"] and probe["sharded_ckpt_ok"]
            and all(x == 1 for x in probe["all_reduce_per_round"])
            and probe["placements"] == ["slices"] * MESH_RANKS
            and not any(r["foreign_modules"] for r in pres)):
        bad.append(f"the grouped probe: {nums['probe']}")
    if bad:
        raise AssertionError(f"grouped mesh at {MESH_RANKS} ranks: {bad}")
    return {"nums": nums, "launches": launches}


def gmesh_phase(torch, counters, out_dir: str, lm_one_rank):
    """Phase 16 (the module docstring); ``lm_one_rank`` phase 7's one-rank
    grouped LM entry round's flat params, which phase 16's two ranks hold
    theirs against -> ({path: launches}, numbers)."""
    import torch.distributed as dist

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.parallel import mesh as M
    from heterofl_tpu_torch.parallel.pod import _free_port

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    plain, launches, nums = {}, {}, {}
    try:
        for name, codec, k in GMESH_RUNS:
            plain[name], _, _, _ = counted_run(
                torch, counters, train_classifier_fed.main,
                gmesh_argv(os.path.join(out_dir, "plain", name), codec, k),
                f"grouped mesh: {name} without a process group")
        plain["slices_span"], _, _, _ = counted_run(
            torch, counters, train_classifier_fed.main,
            gmesh_argv(os.path.join(out_dir, "plain", "slices_span"), "dense", MESH_ROUNDS,
                       MESH_ROUNDS, GMESH_SLICES),
            "grouped mesh: the slices control under span without a process group")
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())}
        saved = {v: os.environ.get(v) for v in env}
        os.environ.update(env)
        try:
            if not M.initialize_distributed(device="cuda") or dist.get_backend() != "nccl":
                raise AssertionError("grouped mesh: no one-rank NCCL group joined")
            for name, codec, k in GMESH_RUNS:
                what = f"gmesh_nccl_{name}"
                M.reset_counts()
                res, secs, launches[what], _ = counted_run(
                    torch, counters, train_classifier_fed.main,
                    gmesh_argv(os.path.join(out_dir, "nccl", name), codec, k),
                    f"grouped mesh: {name} as rank 0 of a one-rank NCCL group")
                colls, n = dict(M.COLLECTIVES), launches[what]
                say(f"grouped mesh: {name}: {secs:.1f} s, collectives {colls}; launches {n}")
                if not gmesh_collectives_ok(colls, MESH_ROUNDS, k):
                    raise AssertionError(f"grouped mesh: {name} made collectives {colls}")
                if not same_run(torch, res, plain[name]):
                    raise AssertionError(f"grouped mesh: {name} under the one-rank NCCL group "
                                         f"is not the run without a group bit for bit")
                if min(n[c] for c in BATCHED) <= 0 or any(n[c] for c in ONE_CLIENT) or \
                        (n["quant_pack"] > 0) != (name == "superstep_map"):
                    raise AssertionError(f"grouped mesh: {name}: launches {n}")
                say(f"grouped mesh: {name} under the one-rank NCCL group equals the run without "
                    f"a group bit for bit (cohorts, logs, params, residual)")
        finally:
            M.shutdown_distributed()
            for v, old in saved.items():
                if old is None:
                    os.environ.pop(v, None)
                else:
                    os.environ[v] = old
        plain_flat = {w: flat_params(r["params"]) for w, r in plain.items()}
        # phase 17b holds its grouped (1, 2) runs against these one-rank runs
        nums["one_rank"] = {w: (plain_flat[w], [h["loss"] for h in plain[w]["history"]])
                            for w in ("k1_dense", "superstep_dense")}
        del plain
        torch.cuda.empty_cache()
        two = gmesh_ranks_check(torch, os.path.join(out_dir, "ranks"), plain_flat, lm_one_rank)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    launches.update(two["launches"])
    nums.update(two["nums"])
    return launches, nums


# --- phase 17: the data mesh axis ---------------------------------------------------------

#: the synchronised batch norm's four kernels (csrc/bn.cu), in path order
SYNC_KERNELS = ("bn_sync_stats", "bn_sync_apply", "bn_sync_bwd_reduce", "bn_sync_bwd_apply")
#: phase 17a's batches: a data rank's half of the headline's batch of 10, and the whole
SYNC_BATCHES = (5, 10)
#: phase 17a's batched pair (rows 1bs/2bs, the grouped engine on the data axis):
#: the batched direction's four kernels, the batch, the (rate, G) held and timed
SYNC_BATCHED_KERNELS = ("bn_sync_stats_batched", "bn_sync_apply", "bn_sync_bwd_reduce",
                        "bn_sync_bwd_apply_batched")
SYNC_BATCHED_BATCH = 5
SYNC_BATCHED_HELD = ((1.0, 2), (0.0625, 2), (0.25, 3))
SYNC_BATCHED_TIMED = ((1.0, 2), (0.0625, 2))
#: kernel against plain: (atol, rtol) of y and dx; the relative error of the
#: channel sums (the same float32 sums over M rows in another order)
TOL_SYNC = {"y": (1e-4, 1e-4), "dx": (1e-4, 1e-4), "sums_rel": 1e-5}
#: phase 17b/c: the data axis's two gloo ranks sharing the card
DATA_MESH = {"clients": 1, "data": 2}
DATA_RUNS = (("k1_dense", "dense", 1), ("k1_int8", "int8", 1),
             ("superstep_dense", "dense", MESH_ROUNDS))
#: phase 17b's grouped runs at (1, 2): (name, codec, K, phase 16's one-rank run)
DATA_GROUPED_RUNS = (("grouped_k1_dense", "dense", 1, "k1_dense"),
                     ("grouped_superstep_dense", "dense", MESH_ROUNDS, "superstep_dense"))
#: the kernels of the grouped engine on the data axis (1bs/2bs and 3b), and
#: those it must not launch (the one-client pair's own, 1b/2b)
GROUPED_DATA_KERNELS = ("bn_sync_stats_batched", "bn_sync_apply", "bn_sync_bwd_reduce",
                        "bn_sync_bwd_apply_batched", "fused_sgd_batched")
GROUPED_DATA_NOT = ("bn_sync_stats", "bn_sync_bwd_apply", "bn_fwd_batched", "bn_bwd_batched",
                    "bn_fwd", "bn_bwd", "fused_sgd")
DATA_RANK_TIMEOUT = 300
#: the (1, 2) headline against one rank, max |params| difference: each BN
#: site's moments are the same one-pass sums in another order (the split
#: pair's two halves, against the one-client kernel's cluster order), which
#: a round carries into the params (1.96e-5 measured on an H100)
TOL_DATA_RANKS = 1e-4
#: int8 at (1, 2) against one rank: the same grid and noise (the clients
#: row is the codec's one participant), but a sum a rounding apart can round
#: to the next grid step: at most this share of entries past TOL_DATA_RANKS
#: (the tests' one-grid-step contract, tests/test_torch_port_pod.py)
DATA_INT8_SHARE = 0.02
#: the LM at (1, 2) against one rank: ring attention's online softmax and the
#: reduced gradient associate otherwise than the dense chain, which the
#: round's steps carry into the params (the card-vs-CPU LM round's bound,
#: TOL_LM_ROUND)
TOL_DATA_LM = 1e-3
DATA_LM_USERS = (0, 1)
DATA_LM_TOKENS = 320  # five windows of 64 a client
DATA_LM_SIZES = {"train": 40000, "test": 4000}  # 400 tokens a user


def sync_bn_check(torch, fused_norm, gen, M: int, C: int, P: int):
    """The four synchronised kernels against their plain versions on the
    same inputs at ``[M, C]`` (a sample of weight 0 included), and a group
    of one through the split pair against ``bn_fwd_cuda``/``bn_bwd_cuda``
    -> (inputs, max abs error by kernel)."""
    x2 = torch.randn(M, C, generator=gen, device="cuda") * 2 + 0.5
    w = torch.ones(M // P, device="cuda")
    w[-1] = 0.0
    g = torch.randn(C, generator=gen, device="cuda")
    b = torch.randn(C, generator=gen, device="cuda")
    dy = torch.randn(M, C, generator=gen, device="cuda")
    err = {}

    def rel(what, a, bb):
        e = float((a - bb).abs().max())
        scale = float(bb.abs().max())
        if not e <= TOL_SYNC["sums_rel"] * max(scale, 1e-30):
            raise AssertionError(f"{what} [{M}, {C}]: {e:.3e} against {scale:.3e} (relative "
                                 f"{TOL_SYNC['sums_rel']})")
        return e

    loc_p = fused_norm.bn_sync_stats_plain(x2, w, P)
    err["bn_sync_stats"] = rel("bn_sync_stats", fused_norm.bn_sync_stats_cuda(x2, w, P), loc_p)
    y_p, st_p = fused_norm.bn_sync_apply_plain(x2, g, b, loc_p)
    y_k, st_k = fused_norm.bn_sync_apply_cuda(x2, g, b, loc_p)
    err["bn_sync_apply"] = max(check_close(f"bn_sync_apply y [{M}, {C}]", y_k, y_p,
                                           *TOL_SYNC["y"]),
                               check_close(f"bn_sync_apply stats [{M}, {C}]", st_k, st_p,
                                           *TOL_SYNC["y"]))
    r_p = fused_norm.bn_sync_bwd_reduce_plain(x2, dy, st_p)
    err["bn_sync_bwd_reduce"] = rel("bn_sync_bwd_reduce",
                                    fused_norm.bn_sync_bwd_reduce_cuda(x2, dy, st_p), r_p)
    dx_p = fused_norm.bn_sync_bwd_apply_plain(x2, w, P, g, dy, st_p, r_p)
    err["bn_sync_bwd_apply"] = check_close(
        f"bn_sync_bwd_apply dx [{M}, {C}]",
        fused_norm.bn_sync_bwd_apply_cuda(x2, w, P, g, dy, st_p, r_p), dx_p, *TOL_SYNC["dx"])
    # a group of one: the split pair end to end against the one-client kernels
    y1, st1 = fused_norm.bn_fwd_cuda(x2, w, P, g, b)
    ys, sts = fused_norm.bn_sync_apply_cuda(x2, g, b, fused_norm.bn_sync_stats_cuda(x2, w, P))
    check_close(f"group of one y [{M}, {C}]", ys, y1, *TOL_BN["y"])
    dx1, _, _ = fused_norm.bn_bwd_cuda(x2, w, P, g, dy, st1)
    dxs = fused_norm.bn_sync_bwd_apply_cuda(x2, w, P, g, dy, sts,
                                            fused_norm.bn_sync_bwd_reduce_cuda(x2, dy, sts))
    check_close(f"group of one dx [{M}, {C}]", dxs, dx1, *TOL_BN["dx"])
    return (x2, w, g, b, dy, loc_p, st_p, r_p), err


def sync_times(kern, plain, lib, nbytes: int, nops: int) -> dict:
    """One synchronised kernel's numbers at one shape: its call and device
    ms (CUDA events; CUDA-graph replay), its plain version's ms, the aten
    yardstick's call and device ms, and its bound from the least bytes and
    operations."""
    return {"ms": time_ms(kern), "device_ms": graph_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib), "library_device_ms": graph_ms(lib),
            "bound_ms": max(nbytes / BW, nops / F32) * 1e3, "bytes": nbytes, "ops": nops}


def sync_bn_phase(torch, fused_norm) -> dict:
    """Phase 17a: the four synchronised kernels held against their plain
    versions at the headline ResNet-18's BN shapes at batch 5 (a data
    rank's half) and 10, and timed: per kernel the totals of one training
    step's sites at each batch (``b<batch>_*``; the kernel's call and
    device time, its plain version's, the yardstick aten op of PyTorch's
    SyncBatchNorm, the byte or operation bound), the launch counters put
    back after, so the main path's counts start from 0."""
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(17)
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")
    tot = {k: {"err": 0.0} for k in SYNC_KERNELS}
    for batch in SYNC_BATCHES:
        for k in SYNC_KERNELS:
            tot[k].update({f"b{batch}_{key}": 0.0 for key in keys + ("bytes", "ops")})
        for M10, C, sites in BN_SHAPES:
            M, P = M10 * batch // BATCH, M10 // BATCH
            (x2, w, g, b, dy, loc, st, red), err = sync_bn_check(torch, fused_norm, gen, M, C, P)
            for k, e in err.items():
                tot[k]["err"] = max(tot[k]["err"], e)
            x4 = x2.view(batch, 1, P, C).permute(0, 3, 1, 2)
            dy4 = dy.view(batch, 1, P, C).permute(0, 3, 1, 2)
            mean, inv = st[0].contiguous(), st[1].contiguous()
            count = torch.full((1,), M, dtype=torch.int32, device="cuda")
            calls = {
                "bn_sync_stats": (lambda: fused_norm.bn_sync_stats_cuda(x2, w, P),
                                  lambda: fused_norm.bn_sync_stats_plain(x2, w, P),
                                  lambda: torch.batch_norm_stats(x4, 1e-5)),
                "bn_sync_apply": (lambda: fused_norm.bn_sync_apply_cuda(x2, g, b, loc),
                                  lambda: fused_norm.bn_sync_apply_plain(x2, g, b, loc),
                                  lambda: torch.batch_norm_elemt(x4, g, b, mean, inv, 1e-5)),
                "bn_sync_bwd_reduce": (
                    lambda: fused_norm.bn_sync_bwd_reduce_cuda(x2, dy, st),
                    lambda: fused_norm.bn_sync_bwd_reduce_plain(x2, dy, st),
                    lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, inv, g, True, True,
                                                             True)),
                "bn_sync_bwd_apply": (
                    lambda: fused_norm.bn_sync_bwd_apply_cuda(x2, w, P, g, dy, st, red),
                    lambda: fused_norm.bn_sync_bwd_apply_plain(x2, w, P, g, dy, st, red),
                    lambda: torch.batch_norm_backward_elemt(dy4, x4, mean, inv, g, red[0],
                                                            red[1], count)),
            }
            # least bytes (each input read once, each output written once) and operations
            nbytes = {"bn_sync_stats": 4 * (M * C + batch + 3 * C),
                      "bn_sync_apply": 4 * (2 * M * C + 8 * C),
                      "bn_sync_bwd_reduce": 4 * (2 * M * C + 5 * C),
                      "bn_sync_bwd_apply": 4 * (3 * M * C + batch + 6 * C)}
            nops = {"bn_sync_stats": 6 * M * C, "bn_sync_apply": 4 * M * C,
                    "bn_sync_bwd_reduce": 5 * M * C, "bn_sync_bwd_apply": 10 * M * C}
            for k, fns in calls.items():
                t = sync_times(*fns, nbytes[k], nops[k])
                say(f"  {k} [{M}, {C}] x{sites}: call {t['ms'] * 1e3:.2f} us, device "
                    f"{t['device_ms'] * 1e3:.2f} us (plain {t['plain_ms'] * 1e3:.2f}, aten "
                    f"{t['library_ms'] * 1e3:.2f}, aten device "
                    f"{t['library_device_ms'] * 1e3:.2f}); bound {t['bound_ms'] * 1e3:.2f} us")
                for key in keys:
                    tot[k][f"b{batch}_{key}"] += sites * t[key]
                tot[k][f"b{batch}_bytes"] += sites * nbytes[k]
                tot[k][f"b{batch}_ops"] += sites * nops[k]
        for k, r in tot.items():
            say(f"{k}, a training step at batch {batch} ({BN_SITES} sites): call "
                f"{r[f'b{batch}_ms']:.4f} ms, device {r[f'b{batch}_device_ms']:.4f} ms, plain "
                f"{r[f'b{batch}_plain_ms']:.4f} ms, aten {r[f'b{batch}_library_ms']:.4f} ms "
                f"(device {r[f'b{batch}_library_device_ms']:.4f} ms); bound "
                f"{r[f'b{batch}_bound_ms']:.4f} ms; max abs err {r['err']:.3e}")
    tot.update(sync_bn_batched_phase(torch, fused_norm, gen))
    for k in fused_norm.SYNC_LAUNCHES:
        fused_norm.SYNC_LAUNCHES[k] = 0
    return tot


def sync_bn_batched_check(torch, fused_norm, gen, M: int, Cg: int, P: int, G: int):
    """The batched synchronised pair (``bn_sync_stats_batched``,
    ``bn_sync_bwd_apply_batched``) and the two kernels it shares with the
    one-client pair (``bn_sync_apply``, ``bn_sync_bwd_reduce``) on G
    clients' ``[M, G * Cg]`` columns against their plain versions (a
    zero-weight sample in the last client), each kernel's two calls equal
    bit for bit -> (inputs, max abs error by kernel)."""
    C = G * Cg
    x2 = torch.randn(M, C, generator=gen, device="cuda") * 2 + 0.5
    w = torch.ones(G, M // P, device="cuda")
    w[-1, -1] = 0.0
    if G > 2:
        w[0, 0] = 0.0
    g = torch.randn(C, generator=gen, device="cuda")
    b = torch.randn(C, generator=gen, device="cuda")
    dy = torch.randn(M, C, generator=gen, device="cuda")
    err = {}

    def rel(what, a, bb):
        e = float((a - bb).abs().max())
        scale = float(bb.abs().max())
        if not e <= TOL_SYNC["sums_rel"] * max(scale, 1e-30):
            raise AssertionError(f"{what} [{M}, {G} x {Cg}]: {e:.3e} against {scale:.3e} "
                                 f"(relative {TOL_SYNC['sums_rel']})")
        return e

    def twice(what, fn):
        a, bb = fn(), fn()
        if not same_bits(torch, a, bb):
            raise AssertionError(f"{what} [{M}, {G} x {Cg}]: two calls differ")
        return a

    loc_p = fused_norm.bn_sync_stats_batched_plain(x2, w, P)
    err["bn_sync_stats_batched"] = rel("bn_sync_stats_batched", twice(
        "bn_sync_stats_batched", lambda: fused_norm.bn_sync_stats_batched_cuda(x2, w, P)), loc_p)
    y_p, st_p = fused_norm.bn_sync_apply_plain(x2, g, b, loc_p)
    y_k, st_k = fused_norm.bn_sync_apply_cuda(x2, g, b, loc_p)
    err["bn_sync_apply"] = max(check_close(f"batched bn_sync_apply y [{M}, {G} x {Cg}]", y_k,
                                           y_p, *TOL_SYNC["y"]),
                               check_close(f"batched bn_sync_apply stats [{M}, {G} x {Cg}]",
                                           st_k, st_p, *TOL_SYNC["y"]))
    r_p = fused_norm.bn_sync_bwd_reduce_plain(x2, dy, st_p)
    err["bn_sync_bwd_reduce"] = rel("batched bn_sync_bwd_reduce",
                                    fused_norm.bn_sync_bwd_reduce_cuda(x2, dy, st_p), r_p)
    dx_p = fused_norm.bn_sync_bwd_apply_batched_plain(x2, w, P, g, dy, st_p, r_p)
    err["bn_sync_bwd_apply_batched"] = check_close(
        f"bn_sync_bwd_apply_batched dx [{M}, {G} x {Cg}]",
        twice("bn_sync_bwd_apply_batched", lambda: fused_norm.bn_sync_bwd_apply_batched_cuda(
            x2, w, P, g, dy, st_p, r_p)), dx_p, *TOL_SYNC["dx"])
    return (x2, w, g, b, dy, loc_p, st_p, r_p), err


def sync_bn_batched_phase(torch, fused_norm, gen) -> dict:
    """Phase 17a's batched pair (rows 1bs/2bs): at the headline ResNet-18's
    BN shapes at batch 5, levels a and e at G = 2 and level c at G = 3 (a
    zero-weight sample), the four kernels of the batched direction held
    against their plain versions (:func:`sync_bn_batched_check`); at G = 1
    each batched kernel against its one-client twin bit for bit (the same
    plan and order of sums); then at ``SYNC_BATCHED_TIMED`` each kernel
    timed by call and by CUDA-graph replay beside its plain version, its
    byte (or operation) bound and the aten op of PyTorch's SyncBatchNorm
    doing its work (call and device) -> ``{kernel: {"err", "<level>_<key>"}}``
    (a training step's 17 sites)."""
    batch = SYNC_BATCHED_BATCH
    out = {k: {"err": 0.0} for k in SYNC_BATCHED_KERNELS}
    for M10, C, _ in BN_SHAPES:
        M, P = M10 * batch // BATCH, M10 // BATCH
        for rate, G in SYNC_BATCHED_HELD:
            _, err = sync_bn_batched_check(torch, fused_norm, gen, M, level_width(C, rate), P, G)
            for k, e in err.items():
                out[k]["err"] = max(out[k]["err"], e)
        # G = 1: the batched kernels are the one-client ones bit for bit
        x2 = torch.randn(M, C, generator=gen, device="cuda")
        w = torch.ones(M // P, device="cuda")
        w[-1] = 0.0
        g, dy = torch.randn(C, generator=gen, device="cuda"), torch.randn(M, C, generator=gen,
                                                                           device="cuda")
        one = fused_norm.bn_sync_stats_cuda(x2, w, P)
        bat = fused_norm.bn_sync_stats_batched_cuda(x2, w[None], P)
        _, st = fused_norm.bn_sync_apply_cuda(x2, g, g, one)
        red = fused_norm.bn_sync_bwd_reduce_cuda(x2, dy, st)
        if not (same_bits(torch, one, bat) and same_bits(
                torch, fused_norm.bn_sync_bwd_apply_cuda(x2, w, P, g, dy, st, red),
                fused_norm.bn_sync_bwd_apply_batched_cuda(x2, w[None], P, g, dy, st, red))):
            raise AssertionError(f"batched sync pair at G = 1 [{M}, {C}]: not the one-client "
                                 f"kernels bit for bit")
    say(f"batched sync pair: at G = 1 equal to the one-client kernels bit for bit at the "
        f"{len(BN_SHAPES)} shapes; max abs err against plain "
        f"{ {k: r['err'] for k, r in out.items()} }")
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
            "bytes", "ops")
    for rate, G in SYNC_BATCHED_TIMED:
        lvl = "a" if rate == 1.0 else "e"
        for k in out:
            out[k].update({f"{lvl}_{key}": 0.0 for key in keys})
        for M10, C, sites in BN_SHAPES:
            M, P, Cg = M10 * batch // BATCH, M10 // BATCH, level_width(C, rate)
            (x2, w, g, b, dy, loc, st, red), _ = sync_bn_batched_check(
                torch, fused_norm, gen, M, Cg, P, G)
            CC = G * Cg
            x4 = x2.view(batch, 1, P, CC).permute(0, 3, 1, 2)
            dy4 = dy.view(batch, 1, P, CC).permute(0, 3, 1, 2)
            mean, inv = st[0].contiguous(), st[1].contiguous()
            count = torch.full((1,), M, dtype=torch.int32, device="cuda")
            calls = {
                "bn_sync_stats_batched": (
                    lambda: fused_norm.bn_sync_stats_batched_cuda(x2, w, P),
                    lambda: fused_norm.bn_sync_stats_batched_plain(x2, w, P),
                    lambda: torch.batch_norm_stats(x4, 1e-5)),
                "bn_sync_apply": (lambda: fused_norm.bn_sync_apply_cuda(x2, g, b, loc),
                                  lambda: fused_norm.bn_sync_apply_plain(x2, g, b, loc),
                                  lambda: torch.batch_norm_elemt(x4, g, b, mean, inv, 1e-5)),
                "bn_sync_bwd_reduce": (
                    lambda: fused_norm.bn_sync_bwd_reduce_cuda(x2, dy, st),
                    lambda: fused_norm.bn_sync_bwd_reduce_plain(x2, dy, st),
                    lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, inv, g, True, True,
                                                             True)),
                "bn_sync_bwd_apply_batched": (
                    lambda: fused_norm.bn_sync_bwd_apply_batched_cuda(x2, w, P, g, dy, st, red),
                    lambda: fused_norm.bn_sync_bwd_apply_batched_plain(x2, w, P, g, dy, st, red),
                    lambda: torch.batch_norm_backward_elemt(dy4, x4, mean, inv, g, red[0],
                                                            red[1], count)),
            }
            # least bytes (each input read once, each output written once) and operations
            nbytes = {"bn_sync_stats_batched": 4 * (M * CC + G * batch + 3 * CC),
                      "bn_sync_apply": 4 * (2 * M * CC + 8 * CC),
                      "bn_sync_bwd_reduce": 4 * (2 * M * CC + 5 * CC),
                      "bn_sync_bwd_apply_batched": 4 * (3 * M * CC + G * batch + 6 * CC)}
            nops = {"bn_sync_stats_batched": 6 * M * CC, "bn_sync_apply": 4 * M * CC,
                    "bn_sync_bwd_reduce": 5 * M * CC, "bn_sync_bwd_apply_batched": 10 * M * CC}
            for k, fns in calls.items():
                t = sync_times(*fns, nbytes[k], nops[k])
                for key in keys:
                    out[k][f"{lvl}_{key}"] += sites * t[key]
        for k, r in out.items():
            say(f"{k}, batched, level {lvl} at G {G}, a training step at batch {batch} "
                f"({BN_SITES} sites): call {r[f'{lvl}_ms']:.4f} ms, device "
                f"{r[f'{lvl}_device_ms']:.4f} ms, plain {r[f'{lvl}_plain_ms']:.4f} ms, aten "
                f"{r[f'{lvl}_library_ms']:.4f} ms (device {r[f'{lvl}_library_device_ms']:.4f} "
                f"ms); bound {r[f'{lvl}_bound_ms']:.4f} ms")
    return {f"batched_{k}" if k in SYNC_KERNELS else k: r for k, r in out.items()}


def data_argv(out_dir: str, codec: str, k: int):
    """Phase 17b's flags: phase 15's headline flags on the ``(1, 2)`` mesh."""
    return mesh_argv(out_dir, codec, k) + ["--mesh", json.dumps(DATA_MESH)]


def data_lm_cfg():
    """Phase 17c's LM: the full-width transformer of the LM control, dropout 0."""
    cfg = lm_cfg()
    cfg["transformer"] = dict(cfg["transformer"], dropout=0.0)
    return cfg


def data_lm_runs(torch, mesh, dense: bool) -> dict:
    """Phase 17c on ``mesh``: one masked LM round of ``DATA_LM_USERS`` on
    their first ``DATA_LM_TOKENS`` tokens (draws from each client's
    generator), the same round through the grouped engine (the two users
    one level-a batch of G = 2), then ``SeqParallelLM.forward`` and one
    ``train_step`` on a ``[4, bptt]`` batch -- the ring over the mesh's data
    axis, or (``dense``, one rank) the model's dense attention -> params
    and losses, host arrays."""
    from heterofl_tpu_torch.data import batchify, fetch_dataset
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
    from heterofl_tpu_torch.parallel.long_context import SeqParallelLM

    cfg = data_lm_cfg()
    dev = mesh.device
    tok = fetch_dataset("WikiText2", synthetic=True,
                        synthetic_sizes=DATA_LM_SIZES)["train"].token
    rows = torch.from_numpy(batchify(tok, 100)[:, None, :DATA_LM_TOKENS]).to(dev)
    lm = torch.ones((100, cfg["num_tokens"]), device=dev)
    model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(dev)
    eng = RoundEngine(model, cfg, dev, mesh)
    P = eng.flatten(model.params())
    new, ms = eng.train_round(P, cfg["lr"], list(DATA_LM_USERS), (rows, lm), 0)
    geng = GroupedRoundEngine(model, dict(cfg, strategy="grouped"), dev, mesh)
    g_new, g_ms = geng.train_round(P, cfg["lr"], list(DATA_LM_USERS), (rows, lm), 0)
    seq = SeqParallelLM(cfg, mesh, dense=dense)
    params = seq.init(torch.Generator().manual_seed(1))
    labels = rows[:4, 0, :cfg["bptt"]].contiguous()
    loss = seq.forward(params, labels, torch.Generator(device=dev).manual_seed(5))
    p2, _, step_loss = seq.train_step(params, seq.init_opt(params), labels, cfg["lr"],
                                      torch.Generator(device=dev).manual_seed(6))
    flat = torch.cat([p2[k].reshape(-1) for k in sorted(p2)])
    return {"round": new.cpu().numpy(), "loss_sum": ms["loss_sum"].cpu().numpy().tolist(),
            "grouped_round": g_new.cpu().numpy(),
            "grouped_loss_sum": g_ms["loss_sum"].cpu().numpy().tolist(),
            "seq_loss": float(loss), "seq_step_loss": float(step_loss),
            "seq_params": flat.detach().cpu().numpy()}


def data_rank_main(torch, out_dir: str, backend: str) -> None:
    """One rank of phase 17b/c (``chip_smoke.py --data-rank OUT_DIR``,
    started with torchrun's variables by ``parallel/pod.py::_spawn``): joins
    the ``backend`` group on the card and runs the headline entry at each
    of ``DATA_RUNS`` and, with ``--strategy grouped``, ``DATA_GROUPED_RUNS``
    on the ``(1, 2)`` mesh, each run's launches and collectives counted
    from 0 -- each engine's first on rank 0 inside a profiler trace whose
    hand-written kernels must equal the counters (taken again, on every
    rank, up to ``TRACE_TRIES``) -- then phase 17c's LM rounds (masked and
    grouped) and ``SeqParallelLM``.  Writes each run's params as
    ``<run>_rank<r>.npy`` and ``data_rank<r>.json``."""
    import hashlib

    import numpy as np

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.ops import fused_norm, fused_update, quant
    from heterofl_tpu_torch.parallel import mesh as M

    t_enter = time.time()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    if not M.initialize_distributed(backend, "cuda"):
        raise AssertionError("data mesh rank: started without torchrun's variables")
    mesh = M.make_mesh(0, DATA_MESH["data"], device=torch.device("cuda"))
    rank = mesh.world_rank
    counters = (fused_norm.LAUNCHES, fused_norm.SYNC_LAUNCHES, fused_update.LAUNCHES,
                quant.LAUNCHES)
    out = {"rank": rank, "backend": mesh.backend}
    runs = [(what, codec, k, ()) for what, codec, k in DATA_RUNS] + \
        [(what, codec, k, ("--strategy", "grouped")) for what, codec, k, _ in DATA_GROUPED_RUNS]
    for what, codec, k, extra in runs:
        traced = what in ("k1_dense", "grouped_k1_dense")
        for attempt in range(1, TRACE_TRIES + 1):
            M.reset_counts()
            argv = data_argv(os.path.join(out_dir, "entry", f"{what}_{attempt}"), codec, k) + \
                list(extra)
            holder = {}

            def go():
                holder["r"] = counted_run(torch, counters, train_classifier_fed.main, argv,
                                          f"data mesh rank {rank}: {what}")

            prof = trace(go, cpu=False)[0] if traced and rank == 0 else go()
            res, secs, launches, _ = holder["r"]
            colls, dcolls = dict(M.COLLECTIVES), dict(M.DATA_COLLECTIVES)
            got = traced_kernels(prof) if prof is not None else None
            ok = got is None or all(got[kk] == launches.get(kk, 0) for kk in KERNEL_OF)
            if traced and not mesh.broadcast_int(int(ok)):
                if rank == 0 and any(got[kk] > launches.get(kk, 0) for kk in KERNEL_OF):
                    raise AssertionError(f"{what}: the trace counted {got} kernels, more than "
                                         f"the launch counters' {launches}")
                say(f"{what}: trace {attempt} counted {got}, not the counters' {launches}")
                continue
            break
        else:
            raise AssertionError(f"{what}: no trace counted the launches {launches}")
        np.save(os.path.join(out_dir, f"{what}_rank{rank}.npy"), flat_params(res["params"]))
        resid = res["wire_resid"]
        out[what] = {"seconds": secs, "collectives": colls, "data_collectives": dcolls,
                     "launches": launches, "traced": got,
                     "loss": [h["loss"] for h in res["history"]],
                     "resid_sha256": None if resid is None else hashlib.sha256(
                         np.ascontiguousarray(resid).tobytes()).hexdigest()}
        say(f"data mesh rank {rank}: {what}: {secs:.1f} s, collectives {colls}, data axis "
            f"{dcolls}, launches {launches}")
    M.reset_counts()
    t0 = time.time()
    lm = data_lm_runs(torch, mesh, dense=False)
    torch.cuda.synchronize()
    out["lm"] = {"seconds": time.time() - t0, "data_collectives": dict(M.DATA_COLLECTIVES),
                 "loss_sum": lm["loss_sum"], "grouped_loss_sum": lm["grouped_loss_sum"],
                 "seq_loss": lm["seq_loss"], "seq_step_loss": lm["seq_step_loss"]}
    np.save(os.path.join(out_dir, f"lm_round_rank{rank}.npy"), lm["round"])
    np.save(os.path.join(out_dir, f"lm_grouped_rank{rank}.npy"), lm["grouped_round"])
    np.save(os.path.join(out_dir, f"lm_seq_rank{rank}.npy"), lm["seq_params"])
    out["t_enter"], out["t_exit"] = t_enter, time.time()
    with open(os.path.join(out_dir, f"data_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    M.shutdown_distributed()


def data_phase(torch, counters, out_dir: str, one_rank=None, grouped_one_rank=None):
    """Phase 17b-d (the module docstring): the one-rank runs (phase 15's
    ``one_rank``, ``{mesh_name: (flat params, losses)}``, and phase 16's
    ``grouped_one_rank``, ``{name: (flat params, losses)}``, the same entry
    runs without a process group; made here where not given), the two
    ranks spawned (gloo sharing the card; NCCL across two GPUs where the
    machine has them) -> ({path: launches}, numbers)."""
    import numpy as np

    from heterofl_tpu_torch.entry import train_classifier_fed
    from heterofl_tpu_torch.ops import fused_norm
    from heterofl_tpu_torch.parallel import mesh as M
    from heterofl_tpu_torch.parallel import pod

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    counters = tuple(counters) + (fused_norm.SYNC_LAUNCHES,)
    plain, launches, nums = {}, {}, {"runs": {}}
    t0 = time.time()
    try:
        for what, codec, k in DATA_RUNS:
            if one_rank is not None:
                plain[what] = one_rank[mesh_name(codec, k)]
                continue
            res, secs, launches[f"data_one_rank_{what}"], _ = counted_run(
                torch, counters, train_classifier_fed.main,
                mesh_argv(os.path.join(out_dir, "one", what), codec, k),
                f"data mesh: {what} on one rank")
            plain[what] = (flat_params(res["params"]), [h["loss"] for h in res["history"]])
            del res
        for what, codec, k, one in DATA_GROUPED_RUNS:
            if grouped_one_rank is not None:
                plain[what] = grouped_one_rank[one]
                continue
            res, _, launches[f"data_one_rank_{what}"], _ = counted_run(
                torch, counters, train_classifier_fed.main,
                mesh_argv(os.path.join(out_dir, "one", what), codec, k) +
                ["--strategy", "grouped"], f"data mesh: {what} on one rank")
            plain[what] = (flat_params(res["params"]), [h["loss"] for h in res["history"]])
            del res
        one_lm = data_lm_runs(torch, M.single_mesh(torch.device("cuda")), dense=True)
        torch.cuda.empty_cache()
        say(f"data mesh: the one-rank runs took {time.time() - t0:.1f} s")
        gpus = torch.cuda.device_count()
        backend = "nccl" if gpus >= 2 else "gloo"
        if backend == "gloo":
            say(f"data mesh: {gpus} GPU on this machine: the two ranks share it over gloo "
                f"(NCCL cannot put two ranks on one GPU); phase 17d, NCCL between two GPUs, "
                f"needs a machine with two or more")
        t0 = time.time()
        pod._spawn([sys.executable, os.path.abspath(__file__), "--data-rank", out_dir,
                    "--mesh-backend", backend], 2, DATA_RANK_TIMEOUT, gpus)
        nums["spawn_s"], nums["backend"] = time.time() - t0, backend
        say(f"data mesh: the two ranks' spawn took {nums['spawn_s']:.1f} s")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"data_rank{r}.json")) as f:
            ranks.append(json.load(f))
    say(f"data mesh: the ranks started {[r['t_enter'] - t0 for r in ranks]} s into the spawn "
        f"and left their work {[t0 + nums['spawn_s'] - r['t_exit'] for r in ranks]} s before "
        f"its end")
    per = 1 + 2 * BN_SITES
    grouped = {what for what, _, _, _ in DATA_GROUPED_RUNS}
    for what, codec, k in DATA_RUNS + tuple(g[:3] for g in DATA_GROUPED_RUNS):
        flats = [np.load(os.path.join(out_dir, f"{what}_rank{r}.npy")) for r in range(2)]
        equal = np.array_equal(flats[0], flats[1]) and \
            ranks[0][what]["loss"] == ranks[1][what]["loss"] and \
            ranks[0][what]["resid_sha256"] == ranks[1][what]["resid_sha256"]
        dev = np.abs(flats[0].astype(np.float64) - plain[what][0])
        diff, share = float(np.max(dev)), float(np.mean(dev > TOL_DATA_RANKS))
        close = diff <= TOL_DATA_RANKS if codec != "int8" else share <= DATA_INT8_SHARE
        run = {"ranks_equal": equal, "vs_one_rank": diff, "share_past_tol": share,
               "loss": ranks[0][what]["loss"],
               "loss_one_rank": plain[what][1], "seconds": [rk[what]["seconds"] for rk in ranks],
               "collectives": ranks[0][what]["collectives"],
               "data_collectives": ranks[0][what]["data_collectives"]}
        nums["runs"][what] = run
        grid = f" (at most {DATA_INT8_SHARE:g}: grid steps)" if codec == "int8" else ""
        say(f"data mesh: {what} at (1, 2) on two {backend} ranks: ranks equal bit for bit "
            f"{equal}, max |params - one rank| {diff:.3e}, share past {TOL_DATA_RANKS:g} "
            f"{share:.2e}{grid}, "
            f"losses {run['loss']} (one rank {run['loss_one_rank']}), seconds {run['seconds']}, "
            f"collectives {run['collectives']}, data axis {run['data_collectives']}")
        bad = []
        for rk in ranks:
            n, dc = rk[what]["launches"], rk[what]["data_collectives"]
            launches[f"data_{what}_rank{rk['rank']}"] = n
            if what in grouped:  # 1bs/2bs and 3b: a level step a fused_sgd_batched call
                wrong = min(n[kk] for kk in GROUPED_DATA_KERNELS) <= 0 or \
                    any(n[kk] for kk in GROUPED_DATA_NOT) or n["quant_pack"] > 0
                steps = n["fused_sgd_batched"]
            else:
                wrong = min(n[kk] for kk in SYNC_KERNELS) <= 0 or n["fused_sgd"] <= 0 or \
                    n["bn_fwd"] != 0 or (n["quant_pack"] > 0) != (codec == "int8") or \
                    n["bn_sync_stats_batched"] or n["bn_sync_bwd_apply_batched"]
                steps = n["fused_sgd"]
            if wrong:
                bad.append(f"rank {rk['rank']} launches {n}")
            if not mesh_collectives_ok(rk[what]["collectives"], k) or \
                    dc["all_reduce"] % per or dc["all_reduce"] != steps * per:
                bad.append(f"rank {rk['rank']} collectives {rk[what]['collectives']}, data {dc}")
        traced = ranks[0][what]["traced"]
        if traced is not None:  # each rank's counters against rank 0's trace, by kernel name
            say(f"data mesh: {what}: rank 0's profiler trace counted {traced}")
            bad += [f"rank {rk['rank']} counted {rk[what]['launches']}, the trace {traced}"
                    for rk in ranks
                    if any(rk[what]["launches"].get(kk, 0) != traced[kk] for kk in KERNEL_OF)]
        if not (equal and np.isfinite(flats[0]).all() and close):
            bad.append("the ranks differ, or are not finite, or are past the tolerance of one "
                       "rank")
        if bad:
            raise AssertionError(f"data mesh: {what}: {bad}")
    # 17c: the LM round and SeqParallelLM against one rank (dense attention)
    lm_flats = [np.load(os.path.join(out_dir, f"lm_round_rank{r}.npy")) for r in range(2)]
    glm_flats = [np.load(os.path.join(out_dir, f"lm_grouped_rank{r}.npy")) for r in range(2)]
    seq_flats = [np.load(os.path.join(out_dir, f"lm_seq_rank{r}.npy")) for r in range(2)]
    d_round = float(np.max(np.abs(lm_flats[0].astype(np.float64) - one_lm["round"])))
    d_grouped = float(np.max(np.abs(glm_flats[0].astype(np.float64) - one_lm["grouped_round"])))
    d_seq = float(np.max(np.abs(seq_flats[0].astype(np.float64) - one_lm["seq_params"])))
    l0 = ranks[0]["lm"]
    rel = max(abs(l0["seq_loss"] - one_lm["seq_loss"]) / abs(one_lm["seq_loss"]),
              abs(l0["seq_step_loss"] - one_lm["seq_step_loss"]) / abs(one_lm["seq_step_loss"]))
    nums["lm"] = {"round_vs_one_rank": d_round, "grouped_round_vs_one_rank": d_grouped,
                  "seq_params_vs_dense": d_seq,
                  "seq_loss_rel": rel, "seconds": [rk["lm"]["seconds"] for rk in ranks],
                  "data_collectives": l0["data_collectives"]}
    say(f"data mesh: the LM round at (1, 2) (ring attention) against one rank: max |params| "
        f"{d_round:.3e}; the grouped LM round (G 2 at level a): {d_grouped:.3e}, losses "
        f"{l0['grouped_loss_sum']} (one rank {one_lm['grouped_loss_sum']}); "
        f"SeqParallelLM against dense attention: loss {l0['seq_loss']:.6f} "
        f"({one_lm['seq_loss']:.6f}), step loss {l0['seq_step_loss']:.6f} "
        f"({one_lm['seq_step_loss']:.6f}), max |params| {d_seq:.3e} (tolerance "
        f"{TOL_DATA_LM:g}); data axis {l0['data_collectives']}")
    if not (np.array_equal(lm_flats[0], lm_flats[1]) and np.array_equal(*seq_flats)
            and np.array_equal(*glm_flats) and d_grouped <= TOL_DATA_LM
            and d_round <= TOL_DATA_LM and d_seq <= TOL_DATA_LM and rel <= TOL_DATA_LM
            and l0["data_collectives"]["ring_shift"] > 0):
        raise AssertionError(f"data mesh: the LM at (1, 2): {nums['lm']}")
    return launches, nums


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--local-epochs", type=int, default=1,
                        help="local epochs of the main paths (the control's own is 5)")
    parser.add_argument("--mesh-rank", metavar="OUT_DIR", default=None,
                        help="run one rank of phase 15c into OUT_DIR (started by phase 15 "
                             "itself, with torchrun's variables)")
    parser.add_argument("--gmesh-rank", metavar="OUT_DIR", default=None,
                        help="run one rank of phase 16 into OUT_DIR (started by phase 16 "
                             "itself, with torchrun's variables)")
    parser.add_argument("--data-rank", metavar="OUT_DIR", default=None,
                        help="run one rank of phase 17 into OUT_DIR (started by phase 17 "
                             "itself, with torchrun's variables)")
    parser.add_argument("--mesh-backend", choices=("gloo", "nccl"), default="gloo")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA "
              "device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.mesh_rank:
        mesh_rank_main(torch, args.mesh_rank, args.mesh_backend)
        return 0
    if args.gmesh_rank:
        gmesh_rank_main(torch, args.gmesh_rank, args.mesh_backend)
        return 0
    if args.data_rank:
        data_rank_main(torch, args.data_rank, args.mesh_backend)
        return 0
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
    level_n = {rate: FlatSpec.of(dict(make_model(cfg, rate).named_parameters())).total
               for rate in LEVELS}
    lm_level_n = {rate: FlatSpec.of(dict(make_model(lm_cfg(), rate).named_parameters())).total
                  for rate in (1.0, 0.0625)}
    sgd_b = sgd_batched_phase(torch, fused_update, level_n, lm_level_n)
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
        by_path["lm_grouped"], lm_grouped_flat = grouped_lm_path(
            torch, counters, os.path.join(tmp, "lm_grouped"))
        phases.done("grouped LM round")
        graph_nums = graph_check_phase(torch, tmp, args.local_epochs)
        phases.done("CUDA graph checks: replayed draws, a replayed epoch against eager")
        by_path["superstep"], replayed, ss_nums = superstep_path(
            torch, counters, os.path.join(tmp, "superstep"), args.local_epochs)
        replayed_by_path = {"superstep": replayed}
        phases.done("superstep path against the eager rounds")
        (by_path["grouped_superstep_int8"], by_path["grouped_superstep_resumed"],
         replayed_by_path["grouped_superstep_int8"]) = grouped_superstep_path(
            torch, counters, os.path.join(tmp, "grouped_superstep"), args.local_epochs)
        phases.done("grouped int8 superstep and its resumed round")
        by_path["lm_superstep"], replayed_by_path["lm_superstep"] = lm_superstep_path(
            torch, counters, os.path.join(tmp, "lm_superstep"), os.path.join(tmp, "lm"))
        phases.done("LM superstep")
        bf16_accumulate_check(torch)
        bf16_graph = graph_check_phase(torch, tmp, args.local_epochs, "--compute_dtype",
                                       "bfloat16", reps=2, what="bf16 graph")
        by_path["bf16_superstep"], replayed_by_path["bf16_superstep"], bf16_nums = \
            superstep_path(torch, counters, os.path.join(tmp, "bf16_superstep"),
                           args.local_epochs, "--compute_dtype", "bfloat16",
                           what="bf16 superstep path")
        for key in ("eager_run_s", "superstep_run_s", "eager_round_s", "superstep_round_s",
                    "eager_eval_s", "fused_eval_s"):
            clock = "device clock" if key.startswith(("superstep_round", "fused")) else \
                "host clock"
            say(f"bf16 against float32, {key} ({clock}): {bf16_nums[key]} against "
                f"{ss_nums[key]}")
        phases.done("bf16 headline: a replayed epoch, and a superstep against the eager rounds")
        by_path["lm_bf16_superstep"], replayed_by_path["lm_bf16_superstep"], _ = lm_bf16_path(
            torch, counters, os.path.join(tmp, "lm_bf16"))
        phases.done("bf16 LM superstep against the eager rounds")
        by_path.update(im2col_path(torch, counters, os.path.join(tmp, "im2col"),
                                   args.local_epochs))
        phases.done("im2col rounds, masked and grouped, against direct")
        (by_path["codec_map_superstep"], by_path["codec_map_resumed"],
         replayed_by_path["codec_map_superstep"], qp_levels) = codec_map_path(
            torch, counters, os.path.join(tmp, "codec_map"), args.local_epochs, quant, codecs)
        phases.done("per-level codec map superstep and its resumed round")
        # 10. the client scheduler
        gate_kernel_phase(torch, fused_update, level_n)
        phases.done("scenario: kernels under the gates")
        by_path["scenario_masked"], replayed_by_path["scenario_masked"] = scenario_masked_path(
            torch, counters, os.path.join(tmp, "scenario_masked"))
        phases.done("scenario: masked headline, K=1 and superstep, and its resumed round")
        by_path["scenario_grouped"], replayed_by_path["scenario_grouped"] = \
            scenario_grouped_path(torch, counters, os.path.join(tmp, "scenario_grouped"))
        scenario_grouped_int8_phase(torch)
        phases.done("scenario: grouped headline superstep with unfilled slots, resumed; "
                    "grouped int8 round against the CPU")
        by_path["scenario_lm"], replayed_by_path["scenario_lm"] = scenario_lm_path(
            torch, counters, os.path.join(tmp, "scenario_lm"))
        phases.done("scenario: LM superstep against its K=1 rounds")
        # 11. the streaming client store
        for path, (n, rep) in stream_masked_path(torch, counters,
                                                 os.path.join(tmp, "stream_masked")).items():
            by_path[path], replayed_by_path[path] = n, rep
        phases.done("stream: masked headline against the eager store, and its resumed run")
        by_path["stream_grouped_superstep"], replayed_by_path["stream_grouped_superstep"] = \
            stream_grouped_path(torch, counters, os.path.join(tmp, "stream_grouped"))
        scenario_grouped_int8_phase(torch, stream=True)
        phases.done("stream: grouped superstep against the eager store; grouped int8 K=1 "
                    "against the CPU")
        by_path["stream_lm_superstep"], replayed_by_path["stream_lm_superstep"] = \
            stream_lm_path(torch, counters, os.path.join(tmp, "stream_lm"))
        phases.done("stream: LM superstep against the eager store")
        (by_path["stream_population_superstep"],
         replayed_by_path["stream_population_superstep"]), pop_nums = population_phase(
            torch, counters)
        phases.done("stream: population of 1e4 and 1e6 users, and a superstep")
        ring_nums = ring_phase(torch)
        phases.done("stream: the cohort ring at depth 1 and 2")
        # 12. observability and its guards
        obs_dir = os.path.join(tmp, "obs")
        obs_paths, obs_nums = obs_masked_path(torch, counters, obs_dir)
        obs_paths.update(obs_grouped_lm_path(torch, counters, obs_dir))
        obs_paths.update(obs_quarantine_path(torch, counters, obs_dir))
        obs_paths["obs_rollback"] = obs_rollback_path(torch, counters, obs_dir,
                                                      obs_nums["off_run"])
        for path, (n, rep) in obs_paths.items():
            by_path[path], replayed_by_path[path] = n, rep
        phases.done("obs: probes, histograms, ledger, trace and profile; the gate; a rollback")
        # 13. experiment arms and the chaos drill
        arms_paths = arms_path(torch, counters, os.path.join(tmp, "arms"), "masked")
        arms_paths.update(arms_path(torch, counters, os.path.join(tmp, "arms"), "grouped"))
        arms_paths.update(drill_path(torch, counters, os.path.join(tmp, "drill")))
        for path, (n, rep) in arms_paths.items():
            by_path[path], replayed_by_path[path] = n, rep
        phases.done("arms: masked int8 and grouped against the plain and solo runs, resumed; "
                    "the chaos drill")
        # 14. the profile and the audit
        process_rows = process_phase(tmp)
        profile = profile_phase(torch, os.path.join(tmp, "profile"))
        by_path["audit"], replayed_by_path["audit"], audit = audit_phase(
            torch, counters, os.path.join(tmp, "staticcheck.json"))
        flop_rate = flop_rate_phase(torch)
        phases.done("profile and audit: make_summary, staticcheck --flagship, process, the "
                    "FLOP rate")
        # 15. the clients mesh axis
        P = spec.flatten(dict(model.named_parameters())).detach().cuda()
        mesh_n, mesh_rep, mesh_nums = mesh_phase(torch, counters, os.path.join(tmp, "mesh"),
                                                 spec, P)
        del P
        by_path.update(mesh_n)
        replayed_by_path.update(mesh_rep)
        phases.done("mesh: the headline under a one-rank NCCL group against no group, the "
                    "round's all-reduce timed, the headline entry and the pod probe at two "
                    "ranks")
        # 16. the grouped engine on the clients mesh axis
        gmesh_n, gmesh_nums = gmesh_phase(torch, counters, os.path.join(tmp, "gmesh"),
                                          lm_grouped_flat)
        del lm_grouped_flat
        by_path.update(gmesh_n)
        phases.done("grouped mesh: the grouped headline under a one-rank NCCL group against no "
                    "group; span, slices, the map resumed and the grouped probe at two ranks")
        # 17. the data mesh axis
        sync = sync_bn_phase(torch, fused_norm)
        phases.done("data mesh: the synchronised batch norm's four kernels held and timed")
        data_n, data_nums = data_phase(torch, counters, os.path.join(tmp, "data"),
                                       mesh_nums.pop("one_rank"), gmesh_nums.pop("one_rank"))
        by_path.update(data_n)
        phases.done("data mesh: the headline at (1, 2) on two ranks against one, the LM round "
                    "and SeqParallelLM against dense attention")
    say(f"stream: staging a cohort at {POP_USERS[-1]:,} users {pop_nums['ratio']:.3f}x the host "
        f"seconds at {POP_USERS[0]:,}; prefetches ended with the device busy: "
        + ", ".join(f"depth {d} {n['busy']}" for d, n in ring_nums.items()))
    say(f"obs: probe kernels a round {obs_nums['probe_kernels_on']} (on), "
        f"{obs_nums['probe_kernels_hist']} (hist), the gate {obs_nums['gate_kernels']} a client, "
        f"{obs_nums['probe_ms']:.4f} ms a round; the tail round's device seconds off "
        f"{obs_nums['superstep_s_off']:.4f}, hist {obs_nums['superstep_s_hist']:.4f} (device "
        f"clock); update_norm against the fetched params {obs_nums['norm_rel']:.2e} relative")
    say(f"profile and audit: {len(audit['programs'])} programs audited with no finding; "
        f"results aggregated in {len(process_rows)} directories; headline level a "
        f"{profile['resnet18']['a']['params']:,} params, {profile['resnet18']['a']['step_flops']:.6e}"
        f" FLOPs a step, {flop_rate['tflops']:.3f} TFLOP/s replayed ({flop_rate['card']})")
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
        if r is qp:  # and at the per-level map's int8 levels' sliced n
            kernels[-1]["by_level"] = {
                f"{rate:g}": {"n": q["bytes"] // 17, "ms": q["ms"], "device_ms": q["device_ms"],
                              "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
                              "max_abs_err": q["err"]} for rate, q in qp_levels.items()}
            kernels[-1]["max_abs_err"] = max([kernels[-1]["max_abs_err"]]
                                             + [q["err"] for q in qp_levels.values()])
        if r is sgd:  # and at ResNet-50's n; kernels a call from a profiler trace
            kernels[-1].update(kernels_per_call=sgd["kernels_per_call"],
                               max_abs_err=max(kernels[-1]["max_abs_err"], sgd_r50["err"]),
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
        if r is sgd_b:
            kernels[-1]["kernels_per_call"] = sgd_b["kernels_per_call"]
    for name, repl in zip(SYNC_KERNELS, ("heterofl_tpu/ops/layers.py:155",) * 2
                          + ("heterofl_tpu/ops/layers.py:166",) * 2):
        r = sync[name]
        n = sum(by_path[f"data_{what}_rank0"][name] for what, _, _ in DATA_RUNS)
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the data mesh path")
        kernels.append({"name": name, "route": "cuda", "source": "heterofl_tpu_torch/csrc/bn.cu",
                        "replaces": repl, "launches": n, "max_abs_err": r["err"],
                        "ms": r["b5_ms"], "plain_ms": r["b5_plain_ms"],
                        "bound_ms": r["b5_bound_ms"],
                        "bound_by": "bytes" if r["b5_bytes"] / BW >= r["b5_ops"] / F32
                        else "operations",
                        "library_ms": r["b5_library_ms"], "device_ms": r["b5_device_ms"],
                        "library_device_ms": r["b5_library_device_ms"],
                        "batch10": {key: r[f"b10_{key}"] for key in
                                    ("ms", "device_ms", "plain_ms", "library_ms",
                                     "library_device_ms", "bound_ms")},
                        "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()}})
        if name in ("bn_sync_apply", "bn_sync_bwd_reduce"):  # on the batched columns too
            r = sync[f"batched_{name}"]
            kernels[-1]["batched"] = {f"level_{lvl}": {key: r[f"{lvl}_{key}"] for key in (
                "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms")}
                for lvl in ("a", "e")}
            kernels[-1]["max_abs_err"] = max(kernels[-1]["max_abs_err"], r["err"])
    # 1bs/2bs: the batched pair's own kernels, launched by 17b's grouped runs
    for name, repl in (("bn_sync_stats_batched", "heterofl_tpu/ops/layers.py:155"),
                       ("bn_sync_bwd_apply_batched", "heterofl_tpu/ops/layers.py:166")):
        r = sync[name]
        n = sum(by_path[f"data_{what}_rank0"][name] for what, _, _, _ in DATA_GROUPED_RUNS)
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the grouped data path")
        kernels.append({"name": name, "route": "cuda", "source": "heterofl_tpu_torch/csrc/bn.cu",
                        "replaces": repl, "launches": n, "max_abs_err": r["err"],
                        "ms": r["a_ms"], "plain_ms": r["a_plain_ms"], "bound_ms": r["a_bound_ms"],
                        "bound_by": "bytes" if r["a_bytes"] / BW >= r["a_ops"] / F32
                        else "operations",
                        "library_ms": r["a_library_ms"], "device_ms": r["a_device_ms"],
                        "library_device_ms": r["a_library_device_ms"],
                        "level_e": {key: r[f"e_{key}"] for key in (
                            "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                            "bound_ms")},
                        "launches_by_path": {p: c.get(name, 0) for p, c in by_path.items()}})
    for k in kernels:
        k["replayed_launches_by_path"] = {p: n.get(k["name"], 0)
                                          for p, n in replayed_by_path.items()}
    say(f"EMNIST statistics: computed in {t_stats:.3f} s, read in {t_stats_read * 1e3:.2f} ms; "
        f"ResNet-50 step {r50_step_ms:.2f} ms")
    say(f"superstep: a level-a step {graph_nums['eager_ms']:.3f} ms eager, "
        f"{graph_nums['replayed_ms']:.3f} ms replayed (host clock), "
        f"{graph_nums['kernels_per_step']:.1f} kernels a replayed step, device busy "
        f"{100 * graph_nums['busy_share']:.1f}%; two headline rounds, the whole run on the host "
        f"clock: eager {ss_nums['eager_run_s']:.3f} s, superstep {ss_nums['superstep_run_s']:.3f} "
        f"s; rounds eager {ss_nums['eager_round_s']} s (host clock), superstep "
        f"{ss_nums['superstep_round_s']} s (device clock); evaluation eager "
        f"{ss_nums['eager_eval_s']:.3f} s (host clock), fused {ss_nums['fused_eval_s']:.3f} s "
        f"(device clock); "
        f"{ss_nums['captures']} captures in {ss_nums['capture_s']:.2f} s, pools "
        f"{ss_nums['pool_mb']:.1f} MB")
    say(f"bf16 level-a step: {bf16_graph['eager_ms']:.3f} ms eager, "
        f"{bf16_graph['replayed_ms']:.3f} ms replayed (host clock), "
        f"{bf16_graph['kernels_per_step']:.1f} kernels a replayed step, device busy "
        f"{100 * bf16_graph['busy_share']:.1f}%")
    say(f"data mesh: (1, 2) against one rank "
        f"{[(w, r['vs_one_rank']) for w, r in data_nums['runs'].items()]}; the LM "
        f"{data_nums['lm']}; spawn {data_nums['spawn_s']:.1f} s over {data_nums['backend']}; "
        f"the grouped LM at two clients ranks {gmesh_nums['grouped_lm']['vs_one_rank']:.3e} "
        f"from one")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
