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
and launches nothing.

The batched kernels' plan (``bn_plan_batched``, the grouped engine) is held
the same way at the 60 (level, G, site) shapes ``chip_smoke.py`` runs and at
ragged shapes whose channel tiles straddle clients, and each block's weight
stage (``Stage`` in ``bn.cu``) is modelled here and must hold the weight of
every (row, column) the block owns.  The one-client plan is pinned to its
values at ``SHAPES``."""

import numpy as np
import pytest
import torch

from heterofl_tpu_torch.ops import _build, fused_norm
from heterofl_tpu_torch.ops.fused_norm import (BN_MAX_CLUSTER, BN_MAX_TILE_C, BN_SMEM_LIMIT,
                                               BN_STATIC_SMEM, BN_STATIC_SMEM_BATCHED,
                                               BN_THREADS, bn_plan, bn_plan_batched, stage_bytes)
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

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
# the one-client plan at SHAPES, as the batch-norm kernels were redesigned
# with it: (tile_c, tiles, cluster, rows, lanes, iters, resident_fwd,
# resident_bwd, smem_fwd, smem_bwd)
PINNED = {
    (10240, 64): (8, 8, 8, 1280, 128, 10, 1, 1, 33896, 42088),
    (2560, 128): (16, 8, 8, 320, 64, 5, 1, 1, 25704, 25704),
    (640, 256): (32, 8, 8, 80, 32, 3, 1, 1, 25704, 25704),
    (160, 512): (64, 8, 8, 20, 16, 2, 1, 1, 25704, 25704),
    (7840, 16): (8, 2, 16, 490, 128, 4, 1, 1, 25704, 25704),
    (1960, 32): (8, 4, 16, 123, 128, 1, 1, 1, 25704, 25704),
    (999, 20): (8, 3, 8, 125, 128, 1, 1, 1, 25704, 25704),
    (50, 1): (4, 1, 1, 50, 256, 1, 1, 1, 25704, 25704),
    (37, 48): (8, 6, 1, 37, 128, 1, 1, 1, 25704, 25704),
    (3000, 6): (8, 1, 16, 188, 128, 2, 1, 1, 25704, 25704),
    (5, 3): (4, 1, 1, 5, 256, 1, 1, 1, 25704, 25704),
    (1, 1): (4, 1, 1, 1, 256, 1, 1, 1, 25704, 25704),
    (81920, 64): (8, 8, 8, 10240, 128, 80, 0, 0, 25704, 25704),
    (131072, 64): (8, 8, 8, 16384, 128, 128, 0, 0, 25704, 25704),
    (1000000, 3): (4, 1, 16, 62500, 256, 245, 0, 0, 25704, 25704),
    (102400, 64): (8, 8, 8, 12800, 128, 100, 0, 0, 25704, 25704),
    (25600, 128): (16, 8, 8, 3200, 64, 50, 1, 0, 197736, 25704),
    (6400, 256): (32, 8, 8, 800, 32, 25, 1, 1, 95336, 164968),
    (1600, 512): (64, 8, 8, 200, 16, 13, 1, 1, 46184, 66664),
}
# the batched shapes (M, C a client, P, G): ResNet-18's four site shapes at
# batch 10 at every level and G in {1, 2, 4} (chip_smoke.py's 60), then
# ragged ones whose channel tiles straddle clients of 1, 3, 4 and 6 channels
BATCHED = [(M, -(-C0 * num // 16), M // 10, G)
           for num in (16, 8, 4, 2, 1) for G in (1, 2, 4)
           for M, C0 in ((10240, 64), (2560, 128), (640, 256), (160, 512))]
BATCHED += [(999, 1, 111, 5), (3000, 3, 300, 4), (1960, 4, 196, 3), (490, 6, 49, 5),
            (7840, 6, 784, 2), (80, 3, 8, 7)]


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


@pytest.mark.parametrize("M,C", SHAPES)
def test_one_client_plan_is_pinned(M, C):
    """The one-client kernels (rows 1 and 2 of the kernel table) keep their
    plan, so their reduction order and bits, whatever the batched plan does."""
    assert tuple(bn_plan(M, C)) == PINNED[(M, C)]


def _batched(M, Cg, P, G):
    return M, G * Cg, bn_plan_batched(M, G * Cg, Cg, P)


@pytest.mark.parametrize("M,Cg,P,G", BATCHED)
def test_batched_plan_covers_each_row_and_channel_once(M, Cg, P, G):
    """Under ``Layout``, every (row, column) of ``x2 [M, G*Cg]`` is one
    thread's in one block of the batched plan."""
    M, C, pl = _batched(M, Cg, P, G)
    assert np.all(_owners_of_rows(M, pl) == 1)
    assert np.all(_owners_of_channels(C, pl) == 1)
    assert pl.iters * pl.lanes >= pl.rows and (pl.iters - 1) * pl.lanes < pl.rows


@pytest.mark.parametrize("M,Cg,P,G", BATCHED)
def test_batched_weight_stage_covers_each_block(M, Cg, P, G):
    """Each block stages, for every client its channel tile touches, the
    samples its rows span (``Stage``: stage[(client - c_lo) * ns + sample -
    s_lo]); every (row, column) the block owns then finds its own client's
    weight of its sample inside the stage, whose size the launch reserves."""
    M, C, pl = _batched(M, Cg, P, G)
    B = M // P
    w = np.random.default_rng(0).random((G, B))
    cap = stage_bytes(M, C, Cg, P, pl.tile_c, pl.cluster) // 4
    for tile in range(pl.tiles):
        c0 = tile * pl.tile_c
        cols = np.arange(c0, min(C, c0 + pl.tile_c))
        c_lo = c0 // Cg
        for q in range(pl.cluster):
            r0, r1 = q * pl.rows, min((q + 1) * pl.rows, M)
            if r0 >= M:
                continue
            s_lo, ns = r0 // P, (r1 - 1) // P - r0 // P + 1
            n = ((cols[-1]) // Cg - c_lo + 1) * ns
            assert n <= cap
            i = np.arange(n)
            stage = w[c_lo + i // ns, s_lo + i % ns]
            r = np.arange(r0, r1)
            idx = (cols // Cg - c_lo)[None, :] * ns + (r // P - s_lo)[:, None]
            assert idx.min() >= 0 and idx.max() < n
            np.testing.assert_array_equal(stage[idx], w[(cols // Cg)[None, :], (r // P)[:, None]])


@pytest.mark.parametrize("M,Cg,P,G", BATCHED)
def test_batched_plan_is_launchable(M, Cg, P, G):
    """Clusters of at most 16 blocks, lanes of four channels that divide a
    warp, and static plus dynamic shared memory -- rows held past the
    registers (4 row iterations forward, 2 backward) and the weight stage --
    within a block's 232,448 bytes."""
    M, C, pl = _batched(M, Cg, P, G)
    assert 1 <= pl.cluster <= BN_MAX_CLUSTER and pl.cluster & (pl.cluster - 1) == 0
    assert pl.tile_c in (4, 8, 16, 32, 64, 128) and 32 % (pl.tile_c // 4) == 0
    stage = stage_bytes(M, C, Cg, P, pl.tile_c, pl.cluster)
    assert stage % 16 == 0 and stage > 0
    for smem, resident, static, tensors, held in (
            (pl.smem_fwd, pl.resident_fwd, BN_STATIC_SMEM_BATCHED, 1, 4),
            (pl.smem_bwd, pl.resident_bwd, BN_STATIC_SMEM, 2, 2)):
        stash = max(0, pl.iters - held) * BN_THREADS * 16
        assert smem == static + (tensors * stash if resident else 0) + stage <= BN_SMEM_LIMIT
        assert resident == (static + tensors * stash + stage <= BN_SMEM_LIMIT)


def test_batched_plan_is_a_pure_function_of_the_shape():
    """The same shape gives the same batched plan whatever was planned
    before, with or without the cache; a shape that is not whole clients
    and samples is refused."""
    keys = [(M, G * Cg, Cg, P) for M, Cg, P, G in BATCHED]
    first = [bn_plan_batched(*k) for k in keys]
    bn_plan_batched.cache_clear()
    again = [bn_plan_batched.__wrapped__(*k) for k in reversed(keys)][::-1]
    assert first == again == [bn_plan_batched(*k) for k in keys]
    with pytest.raises(ValueError, match="clients"):
        bn_plan_batched(100, 10, 3, 10)
