"""Train-time batch norm through hand-written CUDA kernels.

Port of ``heterofl_tpu/ops/pallas_norm.py`` (the Pallas TPU kernels
``_bn_fwd_kernel``/``_bn_bwd_kernel``, entry ``batch_norm_pallas``).  The
kernels are ``csrc/bn.cu``, one launch per direction: a thread-block cluster
per channel tile reduces across its blocks through distributed shared
memory, on the launch plan :func:`bn_plan` computes from ``(M, C)`` alone.
Beside each kernel is its plain PyTorch version (:func:`bn_fwd_plain`,
:func:`bn_bwd_plain`) with the same arithmetic, and a launch counter
(:data:`LAUNCHES`, one per wrapper call, which is one device launch).

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises -- there is no fallback on the
card.  The gradient is a ``torch.autograd.Function`` whose backward is the
backward kernel; it saves ``(x2, w, g, stats)``, the reference's residuals.

The batched pair (:func:`bn_fwd_batched`, :func:`bn_bwd_batched`; the
reference's kernels under ``jax.vmap`` over a level's clients, the grouped
engine) takes ``x2 [M, G*C]``, a grouped convolution's clients-in-channels
output viewed as rows: column c belongs to client ``c // C`` and takes the
weight ``w[c // C, r // P]`` of its own client's sample, ``w`` ``[G,
B]``.  Each column's mean, variance and count come from its client's
weighted rows only, so ``stats`` holds a count per column.  A channel tile
of the launch plan may straddle two clients (at level e ResNet-18's stages
are 4 to 32 channels wide and tiles at least 8): the weight is resolved per
column, never per tile.  One launch a direction replaces G, on the plan
:func:`bn_plan_batched` computes from the shape; each block stages the
weights it needs in shared memory, and each launch is a programmatic
dependent launch (:data:`BN_BATCHED_PDL`).

The synchronised pair (:func:`batch_norm_sync`; the data axis, where a
client's batch is split over ranks) is the reference's XLA sync form
(``heterofl_tpu/ops/layers.py::batch_norm(axis_name=)`` :155-172, which
its ``norms.py:44-46`` runs instead of Pallas) split at its all-reduces
into four kernels of ``csrc/bn.cu``: :func:`bn_sync_stats` (this rank's
``(sum w x, sum w x^2, sum w)`` ``[3, C]``), the all-reduce over the data
group, :func:`bn_sync_apply` (``y`` and ``stats``), and backward
:func:`bn_sync_bwd_reduce` (this rank's ``(sum dy, sum dy xhat)`` ``[2,
C]``), the all-reduce, :func:`bn_sync_bwd_apply` (``dx``).  The ``dg`` and
``db`` the gradient returns are this rank's LOCAL sums: the step's gradient
all-reduce sums them once, as the reference's ``psum(grads)`` does.  With
a group of one (or none) the plain versions are :func:`bn_fwd_plain` and
:func:`bn_bwd_plain` bit for bit.  Their launches count in
:data:`SYNC_LAUNCHES`.

The batched synchronised pair (:func:`batch_norm_sync_clients`; the
grouped engine on the data axis, a level's G clients' ``[M, G*C]``
columns, each client's batch split over the data group) adds two kernels:
:func:`bn_sync_stats_batched` and :func:`bn_sync_bwd_apply_batched`, the
one-client ones with the weight read per column, ``w[c // C, r // P]`` of
``w [G, B]``, as the batched pair 1b/2b reads it.  ``bn_sync_apply`` and
``bn_sync_bwd_reduce`` read no weight and serve the batched columns as
they are, ``g``/``b`` flattened to ``[G*C]``; the plan is
:func:`bn_sync_plan` of ``(M, G*C)``.  Two all-reduces a site serve all G
clients: ``[3, G*C]`` forward, ``[2, G*C]`` backward.  At G = 1 each
batched kernel equals its one-client twin bit for bit (the same plan and
order of sums).

Semantics (pallas_norm.py:45-109): per-channel weighted moments over all
rows in the ONE-pass form ``var = max(s2/n - mean^2, 0)``; rows whose
sample weight is not positive are excluded from the sums by a select, not
by multiplying, so a non-finite value in such a row does not reach the
statistics; ``y = (x - mean) * inv * g + b`` with ``inv = 1/sqrt(var +
eps)``.  ``stats`` is ``[3, C]`` (mean, inv, n).  The sample-weight
gradient is zero, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

#: kernel launches per wrapper (CUDA only; the plain versions do not count)
LAUNCHES = {"bn_fwd": 0, "bn_bwd": 0, "bn_fwd_batched": 0, "bn_bwd_batched": 0}
#: launches of the synchronised batch norm's four kernels (the data axis)
SYNC_LAUNCHES = {"bn_sync_stats": 0, "bn_sync_apply": 0, "bn_sync_bwd_reduce": 0,
                 "bn_sync_bwd_apply": 0, "bn_sync_stats_batched": 0,
                 "bn_sync_bwd_apply_batched": 0}

# the kernels' fixed shape (csrc/bn.cu): threads per block, row iterations
# a thread keeps in registers, channels per cluster at most, blocks per
# cluster at most (above 8 is non-portable), the shared memory a block may
# use, and the static part of it (2 * 128 + 1 slots of sums for each warp
# and for each block of a cluster, two coefficients per channel, and one
# 8-byte barrier)
BN_THREADS = 256
BN_BATCH = 8
# the batched kernels' row iterations in registers, forward and backward
# (kBatchFwdB, kBatchBwdB in csrc/bn.cu)
BN_BATCH_BATCHED = (4, 2)
BN_MAX_TILE_C = 128
BN_MAX_CLUSTER = 16
BN_SMEM_LIMIT = 232_448
BN_STATIC_SMEM = 4 * ((BN_THREADS // 32 + BN_MAX_CLUSTER) * (2 * BN_MAX_TILE_C + 1)
                      + 2 * BN_MAX_TILE_C) + 8
# the batched forward sums a count per channel: 3 * 128 slots (the batched
# backward's static shared memory is the one-client kernels')
BN_STATIC_SMEM_BATCHED = 4 * ((BN_THREADS // 32 + BN_MAX_CLUSTER) * (3 * BN_MAX_TILE_C)
                              + 2 * BN_MAX_TILE_C) + 8
# blocks per launch the plan aims at: on an H100 (132 SMs) more blocks in
# clusters cost more than they gain at ResNet-18's sites, one-client and
# batched (scripts/bn_plan_sweep.py times every plan, --batched the batched)
_TARGET_BLOCKS = 64
# the batched plan's rows at most for a launch without clusters: two row
# iterations of a tile of 8 channels (128 lanes)
_SMALL_M = 256
#: the batched kernels go out as programmatic dependent launches
BN_BATCHED_PDL = True


class BnPlan(NamedTuple):
    """How one ``[M, C]`` batch norm is cut into a cluster launch."""
    tile_c: int        # channels per cluster: a power of two, 4..128
    tiles: int         # clusters: one per channel tile
    cluster: int       # blocks per cluster, each over its own rows
    rows: int          # rows per block (the last blocks may hold fewer)
    lanes: int         # rows a block reads at once: 256 threads / (tile_c / 4)
    iters: int         # row iterations per thread: rows / lanes, rounded up
    resident_fwd: bool  # the forward keeps its x rows on chip (past 8 iterations:
    resident_bwd: bool  # shared memory); the backward its x and dy rows
    smem_fwd: int      # shared memory per block, bytes
    smem_bwd: int

    @property
    def nonportable(self) -> bool:
        """Clusters above 8 blocks need the kernel's non-portable opt-in."""
        return self.cluster > 8


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _plan(M: int, C: int, tile_c: int, cluster: int, static_fwd: int, static_bwd: int,
          stage: int, batch: Tuple[int, int] = (BN_BATCH, BN_BATCH)) -> BnPlan:
    tiles = -(-C // tile_c)
    lanes = BN_THREADS // (tile_c // 4)
    rows = -(-M // cluster)
    iters = -(-rows // lanes)
    # one tensor's rows past the registers, in shared memory, each direction
    stash_f, stash_b = (max(0, iters - k) * BN_THREADS * 16 for k in batch)
    res_f = static_fwd + stash_f + stage <= BN_SMEM_LIMIT
    res_b = static_bwd + 2 * stash_b + stage <= BN_SMEM_LIMIT
    return BnPlan(tile_c, tiles, cluster, rows, lanes, iters, res_f, res_b,
                  static_fwd + (stash_f if res_f else 0) + stage,
                  static_bwd + (2 * stash_b if res_b else 0) + stage)


def plan_for(M: int, C: int, tile_c: int, cluster: int) -> BnPlan:
    """The one-client plan at a given channel tile and cluster size:
    :func:`bn_plan`'s choice, or one a sweep tries
    (``scripts/bn_plan_sweep.py``).  A thread keeps its first 8 row
    iterations in registers and the rest in shared memory when they fit;
    otherwise the direction's one launch reads those rows twice."""
    return _plan(M, C, tile_c, cluster, BN_STATIC_SMEM, BN_STATIC_SMEM, 0)


def stage_bytes(M: int, C: int, Cg: int, P: int, tile_c: int, cluster: int) -> int:
    """Shared memory of a batched block's weight stage (``Stage`` in
    ``bn.cu``), the largest over the plan's blocks, in whole 16-byte units:
    the clients of the widest channel tile (``Cg`` columns a client) times
    the samples of the widest row range (``P`` rows a sample)."""
    rows = -(-M // cluster)
    nc = max((min(C, c0 + tile_c) - 1) // Cg - c0 // Cg + 1 for c0 in range(0, C, tile_c))
    ns = max((min(M, r0 + rows) - 1) // P - r0 // P + 1 for r0 in range(0, M, rows))
    return -(-nc * ns // 4) * 16


def plan_for_batched(M: int, C: int, Cg: int, P: int, tile_c: int, cluster: int) -> BnPlan:
    """The batched plan at a given channel tile and cluster size: the
    one-client geometry, with the weight stage in each block's shared memory
    (the forward's static part holds a count per channel) and the batched
    kernels' own row iterations in registers (:data:`BN_BATCH_BATCHED`)."""
    return _plan(M, C, tile_c, cluster, BN_STATIC_SMEM_BATCHED, BN_STATIC_SMEM,
                 stage_bytes(M, C, Cg, P, tile_c, cluster), BN_BATCH_BATCHED)


def _tile_and_cluster(M: int, C: int) -> Tuple[int, int]:
    """Channel tiles of at least 8 channels (a full 32-byte sector per row)
    and about 8 tiles; then blocks per cluster, a power of two up to 16,
    for about 64 blocks in all, but no more blocks than one row iteration
    each needs."""
    if M < 1 or C < 1:
        raise ValueError(f"bn_plan: empty batch norm [{M}, {C}]")
    tile_c = min(BN_MAX_TILE_C, max(8, _pow2ceil(-(-C // 8))), max(4, _pow2ceil(C)))
    tiles = -(-C // tile_c)
    lanes = BN_THREADS // (tile_c // 4)
    cluster = 1 << (max(1, _TARGET_BLOCKS // tiles).bit_length() - 1)
    return tile_c, min(cluster, BN_MAX_CLUSTER, _pow2ceil(-(-M // lanes)))


@functools.lru_cache(maxsize=None)
def bn_plan(M: int, C: int) -> BnPlan:
    """The launch plan of both one-client kernels at ``[M, C]``, a pure
    function of the shape, so the reduction order (and so the bits) is
    fixed per shape."""
    return plan_for(M, C, *_tile_and_cluster(M, C))


@functools.lru_cache(maxsize=None)
def bn_plan_batched(M: int, C: int, Cg: int, P: int) -> BnPlan:
    """The launch plan of both batched kernels at ``[M, C]`` (clients of
    ``Cg`` columns, samples of ``P`` rows), a pure function of the shape.

    The one-client rule, except where a tile of 8 channels reads all the
    rows in two row iterations (``M <= 256``): there no cluster, and tiles
    of C / 128 channels (at least 8), so up to 128 blocks of one.  On an
    H100 that beat the one-client rule at every such shape of the grouped
    engine (a site of ResNet-18's last stage), and no simple rule beat it
    elsewhere (``scripts/bn_plan_sweep.py --batched``).  Raises where a
    block's weight stage cannot fit in shared memory."""
    if M < 1 or C < 1:
        raise ValueError(f"bn_plan_batched: empty batch norm [{M}, {C}]")
    if Cg < 1 or P < 1 or C % Cg or M % P:
        raise ValueError(f"bn_plan_batched: [{M}, {C}] is not clients of {Cg} columns "
                         f"and samples of {P} rows")
    if M <= _SMALL_M:
        tile_c = min(BN_MAX_TILE_C, max(8, _pow2ceil(-(-C // 128))), max(4, _pow2ceil(C)))
        pl = plan_for_batched(M, C, Cg, P, tile_c, 1)
    else:
        pl = plan_for_batched(M, C, Cg, P, *_tile_and_cluster(M, C))
    if max(pl.smem_fwd, pl.smem_bwd) > BN_SMEM_LIMIT:
        raise ValueError(f"bn_plan_batched: the weight stage of [{M}, {C}] (Cg {Cg}, P {P}) "
                         f"does not fit in a block's shared memory")
    return pl


def _row_weight(w: torch.Tensor, P: int) -> torch.Tensor:
    return w.repeat_interleave(P).unsqueeze(1)  # [M, 1]


def bn_fwd_plain(x2: torch.Tensor, w: torch.Tensor, P: int, g: torch.Tensor,
                 b: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: ``x2 [M, C]``, per-sample
    weight ``w [M // P]`` -> ``(y2 [M, C], stats [3, C])``."""
    wr = _row_weight(w, P)
    xs = torch.where(wr > 0, x2, torch.zeros((), dtype=x2.dtype, device=x2.device))
    s1 = (xs * wr).sum(0)
    s2 = (xs * xs * wr).sum(0)
    n = wr.sum().clamp_min(1e-6)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    y2 = (x2 - mean) * inv * g + b
    return y2, torch.stack([mean, inv, n.expand_as(mean)])


def bn_bwd_plain(x2: torch.Tensor, w: torch.Tensor, P: int, g: torch.Tensor,
                 dy2: torch.Tensor, stats: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> ``(dx2, dg, db)``."""
    mean, inv, n = stats[0], stats[1], stats[2].clamp_min(1e-6)
    wr = _row_weight(w, P)
    xhat = (x2 - mean) * inv
    db = dy2.sum(0)
    dg = (dy2 * xhat).sum(0)
    dx2 = inv * g * dy2 - wr * (inv / n) * (g * db) - wr * xhat * (inv / n) * (g * dg)
    return dx2, dg, db


def _check_shapes(what, x2, w, P, C, *vecs):
    if x2.dim() != 2 or w.numel() * P != x2.shape[0] or any(v.numel() != C for v in vecs):
        raise ValueError(f"{what}: expected x2 [M, C] with M = len(w) * P and [C] vectors, got "
                         f"{tuple(x2.shape)}, w {tuple(w.shape)}, P {P}")


def bn_fwd_cuda(x2, w, P: int, g, b, eps: float = 1e-5):
    """The forward kernel (``csrc/bn.cu``) on CUDA tensors: one launch."""
    _build.require_cuda("bn_fwd", x2, w, g, b)
    M, C = x2.shape
    _check_shapes("bn_fwd", x2, w, P, C, g, b)
    pl = bn_plan(M, C)
    y2 = torch.empty_like(x2)
    stats = x2.new_empty((3, C))
    _build.check(_build.load().hfl_bn_fwd(
        x2.data_ptr(), w.data_ptr(), P, g.data_ptr(), b.data_ptr(), y2.data_ptr(),
        stats.data_ptr(), M, C, eps, pl.tile_c, pl.cluster, pl.rows, pl.iters,
        pl.resident_fwd, _build.stream_of(x2)), "bn_fwd")
    LAUNCHES["bn_fwd"] += 1
    return y2, stats


def bn_bwd_cuda(x2, w, P: int, g, dy2, stats):
    """The backward kernel (``csrc/bn.cu``) on CUDA tensors: one launch."""
    _build.require_cuda("bn_bwd", x2, w, g, dy2, stats)
    M, C = x2.shape
    _check_shapes("bn_bwd", x2, w, P, C, g)
    if dy2.shape != x2.shape or stats.shape != (3, C):
        raise ValueError(f"bn_bwd: dy2 {tuple(dy2.shape)} and stats {tuple(stats.shape)} "
                         f"for x2 {tuple(x2.shape)}")
    pl = bn_plan(M, C)
    dx2 = torch.empty_like(x2)
    dg, db = x2.new_empty((2, C)).unbind(0)
    _build.check(_build.load().hfl_bn_bwd(
        x2.data_ptr(), w.data_ptr(), P, g.data_ptr(), dy2.data_ptr(), stats.data_ptr(),
        dx2.data_ptr(), dg.data_ptr(), db.data_ptr(), M, C, pl.tile_c, pl.cluster, pl.rows,
        pl.iters, pl.resident_bwd, _build.stream_of(x2)), "bn_bwd")
    LAUNCHES["bn_bwd"] += 1
    return dx2, dg, db


def bn_fwd(x2, w, P, g, b, eps=1e-5):
    """Forward wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_fwd_plain(x2, w, P, g, b, eps)
    return bn_fwd_cuda(x2, w, P, g, b, eps)


def bn_bwd(x2, w, P, g, dy2, stats):
    """Backward wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_bwd_plain(x2, w, P, g, dy2, stats)
    return bn_bwd_cuda(x2, w, P, g, dy2, stats)


class _BatchNormRows(torch.autograd.Function):
    """Differentiable ``[M, C]`` batch norm; the gradient is the backward
    kernel (the reference's ``_bn2d`` custom VJP)."""

    @staticmethod
    def forward(ctx, x2, w, g, b, P: int, eps: float):
        y2, stats = bn_fwd(x2, w, P, g, b, eps)
        ctx.save_for_backward(x2, w, g, stats)
        ctx.P = P
        return y2

    @staticmethod
    def backward(ctx, dy2):
        x2, w, g, stats = ctx.saved_tensors
        dx2, dg, db = bn_bwd(x2, w, ctx.P, g, dy2.contiguous(), stats)
        return dx2, None, dg, db, None, None


def batch_norm_fused(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     sample_weight: Optional[torch.Tensor] = None,
                     eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics normalisation of an NCHW (channels_last) or NC
    tensor through the fused kernels.  A channels_last activation views as
    ``[N*H*W, C]`` without a copy; the output keeps that layout."""
    n, c = x.shape[0], x.shape[1]
    x2 = (x.permute(0, 2, 3, 1) if x.ndim == 4 else x).reshape(-1, c).contiguous()
    P = x2.shape[0] // n
    if sample_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=x.device)
    else:
        w = sample_weight.to(torch.float32).contiguous()
    y2 = _BatchNormRows.apply(x2, w, g.contiguous(), b.contiguous(), P, eps)
    if x.ndim == 4:
        return y2.view(n, x.shape[2], x.shape[3], c).permute(0, 3, 1, 2)
    return y2


# -- the batched pair: a level's G clients in one launch a direction --------

def _col_weight(w: torch.Tensor, P: int, C: int) -> torch.Tensor:
    """``[G, B]`` per-client sample weights -> ``[B*P, G*C]``: row r,
    column c has client ``c // C``'s weight of sample ``r // P``."""
    return w.t().repeat_interleave(P, dim=0).repeat_interleave(C, dim=1)


def bn_fwd_batched_plain(x2: torch.Tensor, w: torch.Tensor, P: int, g: torch.Tensor,
                         b: torch.Tensor, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched forward kernel: ``x2 [M,
    G*C]``, ``w [G, M // P]`` -> ``(y2 [M, G*C], stats [3, G*C])``, each
    column over its own client's weighted rows."""
    wr = _col_weight(w, P, x2.shape[1] // w.shape[0])
    xs = torch.where(wr > 0, x2, torch.zeros((), dtype=x2.dtype, device=x2.device))
    s1 = (xs * wr).sum(0)
    s2 = (xs * xs * wr).sum(0)
    n = wr.sum(0).clamp_min(1e-6)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    y2 = (x2 - mean) * inv * g + b
    return y2, torch.stack([mean, inv, n])


def bn_bwd_batched_plain(x2: torch.Tensor, w: torch.Tensor, P: int, g: torch.Tensor,
                         dy2: torch.Tensor, stats: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the batched backward kernel -> ``(dx2, dg,
    db)``."""
    mean, inv, n = stats[0], stats[1], stats[2].clamp_min(1e-6)
    wr = _col_weight(w, P, x2.shape[1] // w.shape[0])
    xhat = (x2 - mean) * inv
    db = dy2.sum(0)
    dg = (dy2 * xhat).sum(0)
    dx2 = inv * g * dy2 - wr * (inv / n) * (g * db) - wr * xhat * (inv / n) * (g * dg)
    return dx2, dg, db


def _check_batched(what, x2, w, P, *vecs):
    if x2.dim() != 2 or w.dim() != 2 or w.shape[1] * P != x2.shape[0] \
            or x2.shape[1] % w.shape[0] or any(v.numel() != x2.shape[1] for v in vecs):
        raise ValueError(f"{what}: expected x2 [M, G*C] with M = B * P, w [G, B] and [G*C] "
                         f"vectors, got {tuple(x2.shape)}, w {tuple(w.shape)}, P {P}")


def bn_fwd_batched_cuda(x2, w, P: int, g, b, eps: float = 1e-5, plan: Optional[BnPlan] = None):
    """The batched forward kernel (``csrc/bn.cu``) on CUDA tensors: one
    launch, on ``plan`` (a sweep's) or the shape's own."""
    _build.require_cuda("bn_fwd_batched", x2, w, g, b)
    _check_batched("bn_fwd_batched", x2, w, P, g, b)
    M, C = x2.shape
    G, B = w.shape
    pl = plan or bn_plan_batched(M, C, C // G, P)
    y2 = torch.empty_like(x2)
    stats = x2.new_empty((3, C))
    _build.check(_build.load().hfl_bn_fwd_batched(
        x2.data_ptr(), w.data_ptr(), P, B, C // G, g.data_ptr(), b.data_ptr(), y2.data_ptr(),
        stats.data_ptr(), M, C, eps, pl.tile_c, pl.cluster, pl.rows, pl.iters,
        pl.resident_fwd, BN_BATCHED_PDL, _build.stream_of(x2)), "bn_fwd_batched")
    LAUNCHES["bn_fwd_batched"] += 1
    return y2, stats


def bn_bwd_batched_cuda(x2, w, P: int, g, dy2, stats, plan: Optional[BnPlan] = None):
    """The batched backward kernel (``csrc/bn.cu``) on CUDA tensors: one
    launch, on ``plan`` or the shape's own."""
    _build.require_cuda("bn_bwd_batched", x2, w, g, dy2, stats)
    _check_batched("bn_bwd_batched", x2, w, P, g)
    M, C = x2.shape
    G, B = w.shape
    if dy2.shape != x2.shape or stats.shape != (3, C):
        raise ValueError(f"bn_bwd_batched: dy2 {tuple(dy2.shape)} and stats "
                         f"{tuple(stats.shape)} for x2 {tuple(x2.shape)}")
    pl = plan or bn_plan_batched(M, C, C // G, P)
    dx2 = torch.empty_like(x2)
    dg, db = x2.new_empty((2, C)).unbind(0)
    _build.check(_build.load().hfl_bn_bwd_batched(
        x2.data_ptr(), w.data_ptr(), P, B, C // G, g.data_ptr(), dy2.data_ptr(),
        stats.data_ptr(), dx2.data_ptr(), dg.data_ptr(), db.data_ptr(), M, C, pl.tile_c,
        pl.cluster, pl.rows, pl.iters, pl.resident_bwd, BN_BATCHED_PDL, _build.stream_of(x2)),
        "bn_bwd_batched")
    LAUNCHES["bn_bwd_batched"] += 1
    return dx2, dg, db


def bn_fwd_batched(x2, w, P, g, b, eps=1e-5):
    """Batched forward wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_fwd_batched_plain(x2, w, P, g, b, eps)
    return bn_fwd_batched_cuda(x2, w, P, g, b, eps)


def bn_bwd_batched(x2, w, P, g, dy2, stats):
    """Batched backward wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_bwd_batched_plain(x2, w, P, g, dy2, stats)
    return bn_bwd_batched_cuda(x2, w, P, g, dy2, stats)


class _BatchNormRowsBatched(torch.autograd.Function):
    """Differentiable batched ``[M, G*C]`` batch norm; the gradient is the
    batched backward kernel."""

    @staticmethod
    def forward(ctx, x2, w, g, b, P: int, eps: float):
        y2, stats = bn_fwd_batched(x2, w, P, g, b, eps)
        ctx.save_for_backward(x2, w, g, stats)
        ctx.P = P
        return y2

    @staticmethod
    def backward(ctx, dy2):
        x2, w, g, stats = ctx.saved_tensors
        dx2, dg, db = bn_bwd_batched(x2, w, ctx.P, g, dy2.contiguous(), stats)
        return dx2, None, dg, db, None, None


def batch_norm_fused_clients(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                             sample_weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics normalisation of G clients' clients-in-channels
    activation ``x [B, G*C, H, W]`` (channels_last) through the batched
    kernels: ``g``/``b [G, C]``, ``sample_weight [G, B]``."""
    n, c = x.shape[0], x.shape[1]
    x2 = x.permute(0, 2, 3, 1).reshape(-1, c).contiguous()
    y2 = _BatchNormRowsBatched.apply(x2, sample_weight.to(torch.float32).contiguous(),
                                     g.reshape(-1).contiguous(), b.reshape(-1).contiguous(),
                                     x2.shape[0] // n, eps)
    return y2.view(n, x.shape[2], x.shape[3], c).permute(0, 3, 1, 2)


# -- the synchronised batch norm: four kernels, split at the all-reduces ------

#: channels a block of the synchronised kernels owns, and rows it reads at once
SYNC_LANES = 32
SYNC_ROWS = BN_THREADS // 32
# rows a chunk at least (8 a thread) and blocks a launch at most (two an SM
# of an H100)
_SYNC_MIN_ROWS = 64
_SYNC_BLOCKS = 264


class SyncPlan(NamedTuple):
    """How one ``[M, C]`` synchronised batch norm is cut into blocks."""
    tiles: int   # channel tiles of 32
    chunks: int  # row chunks: a block a (tile, chunk)
    rows: int    # rows a chunk (the last may hold fewer)


@functools.lru_cache(maxsize=None)
def bn_sync_plan(M: int, C: int) -> SyncPlan:
    """The launch plan of the four synchronised kernels at ``[M, C]``, a
    pure function of the shape (so the sums' order, and their bits, are
    fixed per shape): chunks of at least 64 rows, at most 264 blocks."""
    if M < 1 or C < 1:
        raise ValueError(f"bn_sync_plan: empty batch norm [{M}, {C}]")
    tiles = -(-C // SYNC_LANES)
    chunks = max(1, min(M // _SYNC_MIN_ROWS, _SYNC_BLOCKS // tiles))
    rows = -(-M // chunks)
    return SyncPlan(tiles, -(-M // rows), rows)


def bn_sync_stats_plain(x2: torch.Tensor, w: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version of ``bn_sync_stats``: ``x2 [M, C]``, ``w [M // P]`` ->
    this rank's ``[3, C]`` (sum w x, sum w x^2, sum w) over the rows whose
    weight is positive (:func:`bn_fwd_plain`'s sums)."""
    wr = _row_weight(w, P)
    xs = torch.where(wr > 0, x2, torch.zeros((), dtype=x2.dtype, device=x2.device))
    s1 = (xs * wr).sum(0)
    s2 = (xs * xs * wr).sum(0)
    return torch.stack([s1, s2, wr.sum().expand_as(s1)])


def bn_sync_apply_plain(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                        glob: torch.Tensor, eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``bn_sync_apply``: the global ``[3, C]`` sums ->
    ``(y2 [M, C], stats [3, C])`` (mean, inv, max(n, 1e-6))."""
    n = glob[2].clamp_min(1e-6)
    mean = glob[0] / n
    var = (glob[1] / n - mean * mean).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + eps)
    return (x2 - mean) * inv * g + b, torch.stack([mean, inv, n])


def bn_sync_bwd_reduce_plain(x2: torch.Tensor, dy2: torch.Tensor, stats: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of ``bn_sync_bwd_reduce``: this rank's ``[2, C]``
    (sum dy, sum dy xhat)."""
    xhat = (x2 - stats[0]) * stats[1]
    return torch.stack([dy2.sum(0), (dy2 * xhat).sum(0)])


def bn_sync_bwd_apply_plain(x2: torch.Tensor, w: torch.Tensor, P: int, g: torch.Tensor,
                            dy2: torch.Tensor, stats: torch.Tensor, glob: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of ``bn_sync_bwd_apply``: ``dx2`` from the global
    ``[2, C]`` sums, :func:`bn_bwd_plain`'s formula."""
    mean, inv, n = stats[0], stats[1], stats[2].clamp_min(1e-6)
    wr = _row_weight(w, P)
    xhat = (x2 - mean) * inv
    db, dg = glob[0], glob[1]
    return inv * g * dy2 - wr * (inv / n) * (g * db) - wr * xhat * (inv / n) * (g * dg)


#: each CUDA device's chunk counters (the reductions leave them zero)
_SYNC_COUNTERS = {}


def _sync_counter(dev: torch.device, tiles: int) -> torch.Tensor:
    c = _SYNC_COUNTERS.get(dev)
    if c is None or c.numel() < tiles:
        c = torch.zeros(max(tiles, 64), dtype=torch.int32, device=dev)
        _SYNC_COUNTERS[dev] = c
    return c


def _sync_reduce_cuda(name: str, entry: str, args, x2, K: int, M: int, C: int) -> torch.Tensor:
    pl = bn_sync_plan(M, C)
    out = x2.new_empty((K, C))
    part = x2.new_empty((pl.chunks, K, C))
    counter = _sync_counter(x2.device, pl.tiles)
    _build.check(getattr(_build.load(), entry)(
        *args, M, C, pl.rows, pl.chunks, part.data_ptr(), counter.data_ptr(), out.data_ptr(),
        _build.stream_of(x2)), name)
    SYNC_LAUNCHES[name] += 1
    return out


def bn_sync_stats_cuda(x2, w, P: int) -> torch.Tensor:
    """``bn_sync_stats`` (``csrc/bn.cu``) on CUDA tensors: one launch."""
    _build.require_cuda("bn_sync_stats", x2, w)
    M, C = x2.shape
    _check_shapes("bn_sync_stats", x2, w, P, C)
    return _sync_reduce_cuda("bn_sync_stats", "hfl_bn_sync_stats",
                             (x2.data_ptr(), w.data_ptr(), P), x2, 3, M, C)


def bn_sync_apply_cuda(x2, g, b, glob, eps: float = 1e-5):
    """``bn_sync_apply`` (``csrc/bn.cu``) on CUDA tensors: one launch."""
    _build.require_cuda("bn_sync_apply", x2, g, b, glob)
    M, C = x2.shape
    if g.numel() != C or b.numel() != C or glob.shape != (3, C):
        raise ValueError(f"bn_sync_apply: g, b [C] and glob [3, C] for x2 {tuple(x2.shape)}")
    pl = bn_sync_plan(M, C)
    y2 = torch.empty_like(x2)
    stats = x2.new_empty((3, C))
    _build.check(_build.load().hfl_bn_sync_apply(
        x2.data_ptr(), g.data_ptr(), b.data_ptr(), glob.data_ptr(), y2.data_ptr(),
        stats.data_ptr(), M, C, pl.rows, pl.chunks, eps, _build.stream_of(x2)), "bn_sync_apply")
    SYNC_LAUNCHES["bn_sync_apply"] += 1
    return y2, stats


def bn_sync_bwd_reduce_cuda(x2, dy2, stats) -> torch.Tensor:
    """``bn_sync_bwd_reduce`` (``csrc/bn.cu``) on CUDA tensors: one launch."""
    _build.require_cuda("bn_sync_bwd_reduce", x2, dy2, stats)
    M, C = x2.shape
    if dy2.shape != x2.shape or stats.shape != (3, C):
        raise ValueError(f"bn_sync_bwd_reduce: dy2 {tuple(dy2.shape)} and stats "
                         f"{tuple(stats.shape)} for x2 {tuple(x2.shape)}")
    return _sync_reduce_cuda("bn_sync_bwd_reduce", "hfl_bn_sync_bwd_reduce",
                             (x2.data_ptr(), dy2.data_ptr(), stats.data_ptr()), x2, 2, M, C)


def bn_sync_bwd_apply_cuda(x2, w, P: int, g, dy2, stats, glob) -> torch.Tensor:
    """``bn_sync_bwd_apply`` (``csrc/bn.cu``) on CUDA tensors: one launch."""
    _build.require_cuda("bn_sync_bwd_apply", x2, w, g, dy2, stats, glob)
    M, C = x2.shape
    _check_shapes("bn_sync_bwd_apply", x2, w, P, C, g)
    if dy2.shape != x2.shape or stats.shape != (3, C) or glob.shape != (2, C):
        raise ValueError(f"bn_sync_bwd_apply: dy2 {tuple(dy2.shape)}, stats "
                         f"{tuple(stats.shape)} and glob {tuple(glob.shape)} for x2 "
                         f"{tuple(x2.shape)}")
    pl = bn_sync_plan(M, C)
    dx2 = torch.empty_like(x2)
    _build.check(_build.load().hfl_bn_sync_bwd_apply(
        x2.data_ptr(), w.data_ptr(), P, g.data_ptr(), dy2.data_ptr(), stats.data_ptr(),
        glob.data_ptr(), dx2.data_ptr(), M, C, pl.rows, pl.chunks, _build.stream_of(x2)),
        "bn_sync_bwd_apply")
    SYNC_LAUNCHES["bn_sync_bwd_apply"] += 1
    return dx2


def bn_sync_stats(x2, w, P):
    """Wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_sync_stats_plain(x2, w, P)
    return bn_sync_stats_cuda(x2, w, P)


def bn_sync_apply(x2, g, b, glob, eps=1e-5):
    """Wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_sync_apply_plain(x2, g, b, glob, eps)
    return bn_sync_apply_cuda(x2, g, b, glob, eps)


def bn_sync_bwd_reduce(x2, dy2, stats):
    """Wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_sync_bwd_reduce_plain(x2, dy2, stats)
    return bn_sync_bwd_reduce_cuda(x2, dy2, stats)


def bn_sync_bwd_apply(x2, w, P, g, dy2, stats, glob):
    """Wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_sync_bwd_apply_plain(x2, w, P, g, dy2, stats, glob)
    return bn_sync_bwd_apply_cuda(x2, w, P, g, dy2, stats, glob)


def _data_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ``mesh``'s data group (itself without one)."""
    return t if mesh is None else mesh.all_reduce_sum([t], axis="data")[0]


class _BatchNormSync(torch.autograd.Function):
    """Differentiable ``[M, C]`` batch norm whose moments are summed over
    the data group of ``mesh`` (``parallel.mesh.Mesh``; None: this rank
    alone): stats, all-reduce ``[3, C]``, apply; backward: the partial
    sums, all-reduce ``[2, C]``, dx.  ``dg`` and ``db`` are this rank's
    local sums (the step's gradient all-reduce adds the other ranks').  A
    ``[G, B]`` weight ``w`` takes the batched pair (G clients' columns)."""

    @staticmethod
    def forward(ctx, x2, w, g, b, P: int, eps: float, mesh):
        stats_fn = bn_sync_stats_batched if w.dim() == 2 else bn_sync_stats
        y2, stats = bn_sync_apply(x2, g, b, _data_sum(mesh, stats_fn(x2, w, P)), eps)
        ctx.save_for_backward(x2, w, g, stats)
        ctx.P, ctx.mesh = P, mesh
        return y2

    @staticmethod
    def backward(ctx, dy2):
        x2, w, g, stats = ctx.saved_tensors
        dy2 = dy2.contiguous()
        local = bn_sync_bwd_reduce(x2, dy2, stats)
        apply_fn = bn_sync_bwd_apply_batched if w.dim() == 2 else bn_sync_bwd_apply
        dx2 = apply_fn(x2, w, ctx.P, g, dy2, stats, _data_sum(ctx.mesh, local))
        return dx2, None, local[1], local[0], None, None, None


def batch_norm_sync(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    sample_weight: Optional[torch.Tensor], mesh, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Batch-statistics normalisation of an NCHW (channels_last) or NC
    tensor with the statistics of the whole batch split over ``mesh``'s
    data group, through the synchronised kernels (their plain versions on
    the CPU)."""
    n, c = x.shape[0], x.shape[1]
    x2 = (x.permute(0, 2, 3, 1) if x.ndim == 4 else x).reshape(-1, c).contiguous()
    if sample_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=x.device)
    else:
        w = sample_weight.to(torch.float32).contiguous()
    y2 = _BatchNormSync.apply(x2, w, g.contiguous(), b.contiguous(), x2.shape[0] // n, eps,
                              mesh)
    if x.ndim == 4:
        return y2.view(n, x.shape[2], x.shape[3], c).permute(0, 3, 1, 2)
    return y2


# -- the batched synchronised pair: a level's G clients on the data axis ------

def bn_sync_stats_batched_plain(x2: torch.Tensor, w: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version of ``bn_sync_stats_batched``: ``x2 [M, G*C]``, ``w [G,
    M // P]`` -> this rank's ``[3, G*C]``, each column's sums over its own
    client's rows whose weight is positive (:func:`bn_sync_stats_plain`'s
    sums, column by column)."""
    C = x2.shape[1] // w.shape[0]
    wr = _col_weight(w, P, C)
    xs = torch.where(wr > 0, x2, torch.zeros((), dtype=x2.dtype, device=x2.device))
    # each client's weight sum over its [M] rows, as the one-client sum
    n = w.t().repeat_interleave(P, dim=0).sum(0).repeat_interleave(C)
    return torch.stack([(xs * wr).sum(0), (xs * xs * wr).sum(0), n])


def bn_sync_bwd_apply_batched_plain(x2: torch.Tensor, w: torch.Tensor, P: int,
                                    g: torch.Tensor, dy2: torch.Tensor, stats: torch.Tensor,
                                    glob: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bn_sync_bwd_apply_batched``: ``dx2`` from the
    global ``[2, G*C]`` sums, each column's weight its client's."""
    mean, inv, n = stats[0], stats[1], stats[2].clamp_min(1e-6)
    wr = _col_weight(w, P, x2.shape[1] // w.shape[0])
    xhat = (x2 - mean) * inv
    db, dg = glob[0], glob[1]
    return inv * g * dy2 - wr * (inv / n) * (g * db) - wr * xhat * (inv / n) * (g * dg)


def bn_sync_stats_batched_cuda(x2, w, P: int) -> torch.Tensor:
    """``bn_sync_stats_batched`` (``csrc/bn.cu``) on CUDA tensors: one launch."""
    _build.require_cuda("bn_sync_stats_batched", x2, w)
    _check_batched("bn_sync_stats_batched", x2, w, P)
    M, C = x2.shape
    G, B = w.shape
    return _sync_reduce_cuda("bn_sync_stats_batched", "hfl_bn_sync_stats_batched",
                             (x2.data_ptr(), w.data_ptr(), P, B, C // G), x2, 3, M, C)


def bn_sync_bwd_apply_batched_cuda(x2, w, P: int, g, dy2, stats, glob) -> torch.Tensor:
    """``bn_sync_bwd_apply_batched`` (``csrc/bn.cu``) on CUDA tensors: one
    launch."""
    _build.require_cuda("bn_sync_bwd_apply_batched", x2, w, g, dy2, stats, glob)
    _check_batched("bn_sync_bwd_apply_batched", x2, w, P, g)
    M, C = x2.shape
    G, B = w.shape
    if dy2.shape != x2.shape or stats.shape != (3, C) or glob.shape != (2, C):
        raise ValueError(f"bn_sync_bwd_apply_batched: dy2 {tuple(dy2.shape)}, stats "
                         f"{tuple(stats.shape)} and glob {tuple(glob.shape)} for x2 "
                         f"{tuple(x2.shape)}")
    pl = bn_sync_plan(M, C)
    dx2 = torch.empty_like(x2)
    _build.check(_build.load().hfl_bn_sync_bwd_apply_batched(
        x2.data_ptr(), w.data_ptr(), P, B, C // G, g.data_ptr(), dy2.data_ptr(),
        stats.data_ptr(), glob.data_ptr(), dx2.data_ptr(), M, C, pl.rows, pl.chunks,
        _build.stream_of(x2)), "bn_sync_bwd_apply_batched")
    SYNC_LAUNCHES["bn_sync_bwd_apply_batched"] += 1
    return dx2


def bn_sync_stats_batched(x2, w, P):
    """Wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_sync_stats_batched_plain(x2, w, P)
    return bn_sync_stats_batched_cuda(x2, w, P)


def bn_sync_bwd_apply_batched(x2, w, P, g, dy2, stats, glob):
    """Wrapper: plain version on the CPU, the kernel on CUDA."""
    if x2.device.type == "cpu":
        return bn_sync_bwd_apply_batched_plain(x2, w, P, g, dy2, stats, glob)
    return bn_sync_bwd_apply_batched_cuda(x2, w, P, g, dy2, stats, glob)


def batch_norm_sync_clients(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                            sample_weight: torch.Tensor, mesh, eps: float = 1e-5
                            ) -> torch.Tensor:
    """Batch-statistics normalisation of G clients' clients-in-channels
    activation ``x [B, G*C, H, W]`` (channels_last), each client's
    statistics over its batch split on ``mesh``'s data group, through the
    batched synchronised kernels (their plain versions on the CPU):
    ``g``/``b [G, C]``, ``sample_weight [G, B]``."""
    n, c = x.shape[0], x.shape[1]
    x2 = x.permute(0, 2, 3, 1).reshape(-1, c).contiguous()
    y2 = _BatchNormSync.apply(x2, sample_weight.to(torch.float32).contiguous(),
                              g.reshape(-1).contiguous(), b.reshape(-1).contiguous(),
                              x2.shape[0] // n, eps, mesh)
    return y2.view(n, x.shape[2], x.shape[3], c).permute(0, 3, 1, 2)
