"""The batch-norm kernels' launch plan (``ops/fused_norm.py::bn_plan``) on
the CPU.

The CUDA kernels of ``csrc/bn.cu`` run only on the card; what decides their
reduction order, and so their bits, is the plan, a pure function of the
shape computed here in Python.  These tests hold it to what the kernels
need at the shapes the port runs -- ResNet-18's four batch-norm sites at
batch 10 (the federated round) and at batch 100 (the centralised
baseline), the MNIST conv twin's, ragged and oversized ones: every row and
channel owned by exactly one thread, clusters the card can launch, shared
memory within a block's limit.  The row and channel ownership below is the
kernels' (``Layout`` in ``bn.cu``).  A CPU tensor takes the plain version
and launches nothing."""

import numpy as np
import pytest
import torch

from heterofl_tpu_torch.ops import _build, fused_norm
from heterofl_tpu_torch.ops.fused_norm import (BN_MAX_CLUSTER, BN_MAX_TILE_C, BN_SMEM_LIMIT,
                                               BN_STATIC_SMEM, BN_THREADS, bn_plan)

SHAPES = [
    (10240, 64), (2560, 128), (640, 256), (160, 512),  # ResNet-18, CIFAR10 at batch 10
    (7840, 16), (1960, 32),                            # MNIST conv twin, 28x28 and 14x14
    (999, 20), (50, 1), (37, 48), (3000, 6), (5, 3), (1, 1),  # ragged; fewer rows than lanes
    (81920, 64), (131072, 64), (1_000_000, 3),          # rows past shared memory
    (102400, 64), (25600, 128), (6400, 256), (1600, 512),  # ResNet-18 at batch 100
]
# the centralised baseline's sites: (M, C) -> whether each direction keeps
# its rows on chip (forward, backward); the rest read them twice
CENTRAL = {(102400, 64): (False, False), (25600, 128): (True, False),
           (6400, 256): (True, True), (1600, 512): (True, True)}


def _owners_of_rows(M, pl):
    """How many (block, row lane, iteration) own each row."""
    count = np.zeros(M, np.int64)
    rl = np.arange(pl.lanes)[:, None]
    k = np.arange(pl.iters)[None, :]
    for q in range(pl.cluster):
        r0, r1 = q * pl.rows, min((q + 1) * pl.rows, M)
        r = (r0 + rl + k * pl.lanes).ravel()
        np.add.at(count, r[r < r1], 1)
    return count


def _owners_of_channels(C, pl):
    """How many (channel tile, lane of four, j) own each channel."""
    groups = pl.tile_c // 4
    c = (np.arange(pl.tiles)[:, None, None] * pl.tile_c
         + 4 * np.arange(groups)[None, :, None] + np.arange(4)[None, None, :]).ravel()
    return np.bincount(c[c < C], minlength=C)


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_covers_each_row_and_channel_once(M, C):
    """Every row is one thread row's in one block and every channel one
    thread lane's in one tile; so every element is one thread's."""
    pl = bn_plan(M, C)
    assert np.all(_owners_of_rows(M, pl) == 1)
    assert np.all(_owners_of_channels(C, pl) == 1)
    assert pl.tiles == -(-C // pl.tile_c) and pl.rows * pl.cluster >= M
    assert pl.iters * pl.lanes >= pl.rows and (pl.iters - 1) * pl.lanes < pl.rows


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_is_launchable(M, C):
    """Lanes of four channels that divide a warp, at most 16 blocks a
    cluster (above 8 only with the non-portable opt-in), and shared memory
    within a block's 232,448 bytes in both directions."""
    pl = bn_plan(M, C)
    assert pl.tile_c in (4, 8, 16, 32, 64, 128) and pl.tile_c <= BN_MAX_TILE_C
    assert 32 % (pl.tile_c // 4) == 0 and pl.lanes == BN_THREADS // (pl.tile_c // 4)
    assert 1 <= pl.cluster <= BN_MAX_CLUSTER and pl.cluster & (pl.cluster - 1) == 0
    assert pl.cluster <= 8 or pl.nonportable
    for smem, resident, tensors in ((pl.smem_fwd, pl.resident_fwd, 1),
                                    (pl.smem_bwd, pl.resident_bwd, 2)):
        assert BN_STATIC_SMEM <= smem <= BN_SMEM_LIMIT
        stash = tensors * max(0, pl.iters - fused_norm.BN_BATCH) * BN_THREADS * 16
        assert smem == BN_STATIC_SMEM + (stash if resident else 0)
        assert resident == (BN_STATIC_SMEM + stash <= BN_SMEM_LIMIT)


def test_plan_is_a_pure_function_of_the_shape():
    """The same (M, C) gives the same plan whatever was planned before, with
    or without the cache; and the main path's shapes keep to about 64
    blocks, no more than 132 (one block per SM of an H100)."""
    first = [bn_plan(M, C) for M, C in SHAPES]
    bn_plan.cache_clear()
    again = [bn_plan.__wrapped__(M, C) for M, C in reversed(SHAPES)][::-1]
    assert first == again == [bn_plan(M, C) for M, C in SHAPES]
    for M, C in SHAPES[:4]:
        pl = bn_plan(M, C)
        assert 32 <= pl.tiles * pl.cluster <= 132
    with pytest.raises(ValueError, match="empty"):
        bn_plan(0, 8)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    """``bn_fwd``/``bn_bwd`` on CPU tensors return the plain versions'
    results exactly and leave the launch counters alone; the library has no
    scratch-size entry any more (one launch, no global scratch)."""
    rng = np.random.default_rng(0)
    M, C, P = 999, 20, 111
    x2, dy2 = (torch.from_numpy(rng.normal(size=(M, C)).astype(np.float32)) for _ in range(2))
    w = torch.ones(M // P)
    w[3] = 0.0
    g, b = (torch.from_numpy(rng.normal(size=C).astype(np.float32)) for _ in range(2))
    before = dict(fused_norm.LAUNCHES)
    y2, st = fused_norm.bn_fwd(x2, w, P, g, b)
    y_p, st_p = fused_norm.bn_fwd_plain(x2, w, P, g, b)
    assert torch.equal(y2, y_p) and torch.equal(st, st_p) and st.shape == (3, C)
    out = fused_norm.bn_bwd(x2, w, P, g, dy2, st)
    ref = fused_norm.bn_bwd_plain(x2, w, P, g, dy2, st)
    assert all(torch.equal(a, r) for a, r in zip(out, ref))
    assert fused_norm.LAUNCHES == before
    assert "hfl_bn_scratch_floats" not in _build._SIGNATURES


@pytest.mark.parametrize("M,C", list(CENTRAL))
def test_central_shapes_plan_within_cluster_limits(M, C):
    """ResNet-18 at batch 100: 64 blocks in 8 portable clusters of 8 at each
    site, at most 12,800 rows a block; the largest site reads its rows twice
    in both directions, the next in the backward -- the re-read path the
    centralised epoch runs in training."""
    pl = bn_plan(M, C)
    assert pl.tiles * pl.cluster == 64 and pl.cluster == 8 and not pl.nonportable
    assert pl.rows * pl.cluster == M and pl.rows <= 12800
    assert (pl.resident_fwd, pl.resident_bwd) == CENTRAL[(M, C)]
    assert max(pl.smem_fwd, pl.smem_bwd) <= BN_SMEM_LIMIT
