"""The batched fused-SGD kernel's launch plan (``ops/fused_update.py::
sgd_plan_batched``) and the grouped engine's padded rows, on the CPU.

Kernel 3b (``csrc/fused_sgd.cu``) runs only on the card.  What fixes its
bits is the order of each row's norm sum: the one-client kernel's virtual
parts (``parts_for(n)``), each summed by 256 threads over chunks ``b*256 +
t + k*parts*256``, part 0 adding the ``n % 4`` tail last, then a 256-wide
tree; the partials summed as the one-client launch B sums them.  These
tests hold the plan to that at the shapes the port runs (ResNet-18's and
the transformer's parameter counts at levels a-e, an odd n, n below 1,024,
G from 1 to 12), model the persistent route's walk over work items (row
group, part) for several grid sizes -- each (row, part, chunk) summed and
updated exactly once -- and model both routes' sum order in numpy float32
against the one-client order, bit for bit.  The grouped engine pads each
client's row to a multiple of 4 entries (``row_stride``); its leaf-major
gather must select the same values as from unpadded rows."""

import numpy as np
import pytest
import torch

from heterofl_tpu_torch import config as C
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.ops import fused_update
from heterofl_tpu_torch.ops.fused_update import (SGD_CLUSTER_PARTS, SGD_MAX_PARTS, SGD_MAX_ROWS,
                                                 SGD_THREADS, SGD_WIDE_ITEMS, FlatSpec,
                                                 sgd_parts, sgd_plan_batched)
from heterofl_tpu_torch.parallel.grouped import Level, row_stride
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

# parameters of a client at levels a-e (rates 1 to 1/16): full-width
# ResNet-18 on CIFAR10 and the transformer on WikiText2 (vocabulary 512),
# from make_model; then an odd n and ones below 1,024
RESNET18_N = (11_172_170, 2_796_714, 701_018, 176_178, 44_510)
LM_N = (2_454_528, 686_848, 208_512, 70_720, 27_168)
OTHER_N = (1_000_001, 1001, 1023, 999, 7, 4, 1)
ALL_N = RESNET18_N + LM_N + OTHER_N
# the one-client kernel's parts at those n (launch A's blocks)
PARTS = {11_172_170: 1024, 2_796_714: 683, 701_018: 172, 176_178: 44, 44_510: 11,
         2_454_528: 600, 686_848: 168, 208_512: 51, 70_720: 18, 27_168: 7,
         1_000_001: 245, 1001: 1, 1023: 1, 999: 1, 7: 1, 4: 1, 1: 1}
GS = tuple(range(1, 13))
# persistent grids: one block, a few, an SM each, two each, and the most
# 256-thread blocks an H100 holds at once (2,048 threads on each of 132 SMs)
GRIDS = (1, 7, 132, 264, 8 * 132)


def _parts_for(n):
    """``parts_for`` of csrc/fused_sgd.cu, written out."""
    chunks, per = n // 4, 4 * 256
    p = (chunks + per - 1) // per
    return 1 if p < 1 else (1024 if p > 1024 else p)


@pytest.mark.parametrize("n", ALL_N)
def test_parts_are_the_one_client_kernels(n):
    assert sgd_parts(n) == _parts_for(n) == PARTS[n]
    assert SGD_THREADS == 256 and SGD_MAX_PARTS == 1024


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("n", ALL_N)
def test_plan_at_the_ports_shapes(n, G):
    """Parts, route, rows a pass and vector width at each (n, G), for the
    grouped engine's padded rows and for unpadded ones."""
    ld = row_stride(n)
    pl = sgd_plan_batched(n, G, ld)
    assert pl.parts == _parts_for(n)
    assert pl.route == ("cluster" if pl.parts <= SGD_CLUSTER_PARTS else "persistent")
    # the fewest groups of at most 8 rows, balanced, where that leaves enough
    # work items to fill the card; else a row a pass
    wide = -(-G // SGD_MAX_ROWS)
    if pl.parts * wide >= SGD_WIDE_ITEMS:
        assert pl.groups == wide and pl.rows * pl.groups >= G > pl.rows * (pl.groups - 1)
    else:
        assert (pl.rows, pl.groups) == (1, G)
    assert 1 <= pl.rows <= SGD_MAX_ROWS
    assert pl.vec == 4  # padded rows: 16-byte chunks
    raw = sgd_plan_batched(n, G, n)
    assert raw.vec == (4 if G == 1 or n % 4 == 0 else 1)  # unpadded rows: scalars
    assert raw._replace(vec=4) == pl


def test_plan_routes_at_the_level_shapes():
    """ResNet-18's levels a-d and the LM's a-d take the persistent route,
    their levels e the cluster route; the rows of a pass are batched at
    ResNet-18's levels a-b and the LM's level a, where a row has 512 parts
    or more; ResNet-18's rows are 2 mod 4, so only the padded stride gives
    them 16-byte chunks."""
    for ns, wide in ((RESNET18_N, 2), (LM_N, 1)):
        plans = [sgd_plan_batched(n, 2, row_stride(n)) for n in ns]
        assert [pl.route for pl in plans] == ["persistent"] * 4 + ["cluster"]
        assert [pl.rows for pl in plans[:4]] == [2] * wide + [1] * (4 - wide)
    assert all(n % 4 == 2 for n in RESNET18_N) and all(n % 4 == 0 for n in LM_N)
    assert [sgd_plan_batched(n, 4, n).vec for n in RESNET18_N] == [1] * 5


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="route"):
        sgd_plan_batched(RESNET18_N[0], 2, RESNET18_N[0], route="cluster")
    with pytest.raises(ValueError, match="route"):
        sgd_plan_batched(1001, 2, 1004, route="tiles")
    for rows in (0, SGD_MAX_ROWS + 1):
        with pytest.raises(ValueError, match="rows"):
            sgd_plan_batched(1001, 2, 1004, rows=rows)
    with pytest.raises(ValueError):
        sgd_plan_batched(1001, 2, 1000)  # rows overlap
    # a measuring override keeps everything else
    pl = sgd_plan_batched(44_510, 4, 44_512, route="persistent", rows=1)
    assert (pl.parts, pl.route, pl.rows, pl.groups, pl.vec) == (11, "persistent", 1, 4, 4)


@pytest.mark.parametrize("n,ld", [(7, 8), (5, 8), (8, 8), (1_000_001, 1_000_004),
                                  (11_172_170, 11_172_172), (2_454_528, 2_454_528)])
def test_row_stride_rounds_up_to_four(n, ld):
    assert row_stride(n) == ld and ld % 4 == 0 and 0 <= ld - n < 4


def _part_chunks(n, parts, b):
    """``[256, k]`` chunk indices part ``b`` of a row of ``n`` entries sums,
    thread by thread in its order; -1 past the row's ``n // 4`` chunks."""
    n4, stride = n // 4, parts * 256
    k = max(1, -(-(n4 - b * 256) // stride)) if n4 > b * 256 else 1
    i = b * 256 + np.arange(256)[:, None] + np.arange(k)[None, :] * stride
    return np.where(i < n4, i, -1)


@pytest.mark.parametrize("n", ALL_N)
def test_parts_cover_each_chunk_once(n):
    """The parts of a row cover its ``n // 4`` chunks exactly once (the
    ``n % 4`` tail is part 0's); at most 4 chunks a thread wherever a row
    has no more parts than the cluster route takes."""
    parts, n4 = sgd_parts(n), n // 4
    count = np.zeros(max(n4, 1), np.int64)
    for b in range(parts):
        c = _part_chunks(n, parts, b)
        np.add.at(count, c[c >= 0], 1)
        if parts <= SGD_CLUSTER_PARTS:
            assert c.shape[1] <= 4
    assert (count[:n4] == 1).all()


def _launch(plan, n, most):
    """``persistent_launch`` of csrc/fused_sgd.cu with ``most`` blocks
    resident: the apply units an item (enough to fill them, at most a
    thread's chunk iterations), then the units spread evenly over the
    fewest waves -> (grid, slices)."""
    items = plan.parts * plan.groups
    iters = -(-(n // 4) // (plan.parts * 256))
    want = -(-most // items)
    slices = want if want < iters else max(iters, 1)
    units = items * slices
    waves = -(-units // most)
    return -(-units // waves), slices


def _walk(plan, grid, slices):
    """The persistent route's walks, block by block (csrc/fused_sgd.cu): in
    the norm pass block x takes work items w = x, x + grid, ... (item w is
    group w // parts, part w % parts); in the apply pass it takes units u =
    x, x + grid, ... in reverse (unit u is item u // slices, the chunks k =
    u % slices mod slices of it) -> ``({x: w array}, {x: u array})``."""
    items = plan.parts * plan.groups
    norm = {x: np.arange(x, items, grid) for x in range(grid)}
    return norm, {x: np.arange(x, items * slices, grid)[::-1] for x in range(grid)}


@pytest.mark.parametrize("G", GS)
@pytest.mark.parametrize("n", RESNET18_N + LM_N + (1_000_001, 1001))
def test_walk_covers_each_row_and_part_once(n, G):
    """On every grid, each pass takes each (row, part) exactly once: the
    groups split the rows, the work items (group, part) are each one
    block's once; the apply pass walks a block's items backwards.  With
    :func:`test_parts_cover_each_chunk_once`, each (row, part, chunk)."""
    pl = sgd_plan_batched(n, G, row_stride(n))
    group_of = np.arange(G) // pl.rows  # the rows a pass of each group
    assert group_of[-1] == pl.groups - 1 and np.bincount(group_of).max() <= pl.rows
    items, iters = pl.parts * pl.groups, -(-(n // 4) // (pl.parts * 256))
    for most in GRIDS:
        grid, slices = _launch(pl, n, most)
        assert 1 <= slices <= max(iters, 1) and grid <= most
        norm, apply = _walk(pl, grid, slices)
        taken = [len(us) for us in apply.values()]  # the units spread evenly
        assert max(taken) - min(taken) <= 1 and max(taken) == -(-items * slices // most)
        w = np.concatenate(list(norm.values()))
        count = np.zeros((pl.groups, pl.parts), np.int64)
        np.add.at(count, np.divmod(w, pl.parts), 1)
        assert (count == 1).all(), most  # so each (row, part): its group's item
        u = np.concatenate(list(apply.values()))
        w, k = np.divmod(u, slices)  # k: the residue of the item's chunk iterations
        count = np.zeros((pl.groups, pl.parts, slices), np.int64)
        np.add.at(count, np.divmod(w, pl.parts) + (k,), 1)
        assert (count == 1).all(), most  # so each (row, part, chunk) with the residues


# -- the sum order, modelled in float32 ------------------------------------


def _tree(v):
    """block_sum: pairs (t, t + s), s = 128 ... 1 -> element 0."""
    v = v.copy()
    s = 128
    while s > 0:
        v[:s] = v[:s] + v[s:2 * s]
        s //= 2
    return v[0]


def _shuffle_sum(x):
    """Five __shfl_down_sync steps over a warp's 32 lanes (a lane whose
    source is past the warp adds its own value) -> lane 0."""
    x = x.copy()
    for s in (16, 8, 4, 2, 1):
        src = np.arange(32) + s
        x = x + np.where(src < 32, x[np.minimum(src, 31)], x)
    return x[0]


def _tree_shuffled(v):
    """rows_sum: block_sum's steps down to s = 32 (the kernels read the
    eight values a thread of warp 0 adds at once), then the warp's
    shuffles."""
    v = v.copy()
    s = 128
    while s >= 32:
        v[:s] = v[:s] + v[s:2 * s]
        s //= 2
    return _shuffle_sum(v[:32])


def _squares(g, mask, denom):
    gm = (g / np.float32(denom)) * mask
    return gm * gm


def _partial(sq, n, parts, b):
    """Part b's sum: thread t's chunks in order, four entries each, the
    tail last in part 0 -> the 256 threads' sums."""
    acc = np.zeros(256, np.float32)
    c = _part_chunks(n, parts, b)
    for k in range(c.shape[1]):
        on = c[:, k] >= 0
        for lane in range(4):
            acc[on] = acc[on] + sq[4 * c[on, k] + lane]
    if b == 0:
        tail = 4 * (n // 4) + np.arange(256)
        on = tail < n
        acc[on] = acc[on] + sq[tail[on]]
    return acc


def _one_client_norm(sq, n):
    """launch A's partials, then launch B's fixed order -> sqrt."""
    parts = sgd_parts(n)
    part = np.array([_tree(_partial(sq, n, parts, b)) for b in range(parts)], np.float32)
    acc = np.zeros(256, np.float32)
    for j in range(0, parts, 256):
        m = min(256, parts - j)
        acc[:m] = acc[:m] + part[j:j + m]
    return np.sqrt(_tree(acc))


def _batched_norms(sqs, n, plan, grid):
    """The persistent route on ``grid`` blocks (each work item's rows
    summed through rows_sum, the partials reduced in the fixed order) and
    the cluster route (the partials pushed to every block, each warp's
    shuffled sum with the lanes past ``parts`` at 0) -> each row's norm."""
    parts = plan.parts
    part = np.full((len(sqs), parts), np.nan, np.float32)
    norm, _ = _walk(plan, grid, 1)
    for ws in norm.values():
        for q, b in zip(*np.divmod(ws, parts)):
            for r in range(q * plan.rows, min(len(sqs), (q + 1) * plan.rows)):
                part[r, b] = _tree_shuffled(_partial(sqs[r], n, parts, b))
    out = {}
    acc = np.zeros((len(sqs), 256), np.float32)
    for j in range(0, parts, 256):
        m = min(256, parts - j)
        acc[:, :m] = acc[:, :m] + part[:, j:j + m]
    out["persistent"] = [np.sqrt(_tree_shuffled(a)) for a in acc]
    if parts <= SGD_CLUSTER_PARTS:
        lanes = np.zeros((len(sqs), 32), np.float32)
        lanes[:, :parts] = np.float32(0) + part
        out["cluster"] = [np.sqrt(_shuffle_sum(a)) for a in lanes]
    return out


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_batched_sum_order_is_the_one_client_order(rows):
    """At ResNet-18's level-e n (11 parts: both routes) with G = 3: every
    route, grid and rows a pass gives each row's norm -- so its clip scale
    and every updated entry -- the one-client kernel's bits."""
    n, G = RESNET18_N[-1], 3
    rng = np.random.default_rng(7)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    denoms = (7.0, 3.0, 1e-6)
    sqs = [_squares(rng.normal(size=n).astype(np.float32) * np.float32(s), mask, d)
           for s, d in zip((1.0, 1e-3, 1e4), denoms)]
    want = [_one_client_norm(sq, n) for sq in sqs]
    pl = sgd_plan_batched(n, G, row_stride(n), route="persistent", rows=rows)
    for grid in (1, 5, 11 * pl.groups, 44):
        got = _batched_norms(sqs, n, pl, grid)
        for route, norms in got.items():
            assert np.array_equal(np.array(norms, np.float32).view(np.int32),
                                  np.array(want, np.float32).view(np.int32)), (route, grid)


# -- the grouped engine's padded rows -----------------------------------------


def _level(model_name, data, override, rate):
    """A level of the grouped engine and the global model's size."""
    cfg = C.default_cfg()
    cfg.update(control=C.parse_control_name("1_5_1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"),
               data_name=data, model_name=model_name, override=override)
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    model = make_model(cfg)
    spec = FlatSpec.of(dict(model.named_parameters()))
    return Level(cfg, rate, model, spec, torch.device("cpu")), spec.total


@pytest.mark.parametrize("model_name,data,override,rate", [
    ("conv", "MNIST", {"conv": {"hidden_size": [8, 16]}}, 1.0),       # n 1,466: 2 mod 4
    ("conv", "MNIST", {"conv": {"hidden_size": [8, 16]}}, 0.0625),    # n 44: 0 mod 4
    ("resnet18", "CIFAR10", {"resnet": {"hidden_size": [8, 16, 16, 16]}}, 0.125),  # 575: 3
])
def test_leaf_major_under_the_padded_stride(model_name, data, override, rate):
    """``Level.leaf_major`` on the ``[G, ld]`` buffers selects the values
    the unpadded ``[G, n]`` map selected; the gradient pack fills the pad
    with zeros, and the batched step on the ``[:, :n]`` views leaves the
    pad as it was and equals the step on contiguous rows."""
    lv, total = _level(model_name, data, override, rate)
    n, ld, G = lv.spec.total, lv.ld, 3
    assert ld == row_stride(n)
    P = torch.randn(total, generator=torch.Generator().manual_seed(0))
    p_rows, buf_rows, g_rows = lv.buffers(P, G)
    assert p_rows.shape == (G, ld) and not p_rows[:, n:].any() and not buf_rows.any()
    flat = P.index_select(0, lv.idx).expand(G, -1).contiguous()  # the unpadded [G, n]
    old = torch.cat([(torch.arange(G)[:, None] * n + torch.arange(
        lv.spec.offsets[k], lv.spec.offsets[k] + lv.spec.sizes[k])).reshape(-1)
        for k in lv.spec.names])
    assert torch.equal(p_rows.view(-1).index_select(0, lv.leaf_major(G)),
                       flat.view(-1).index_select(0, old))
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn((G,) + lv.spec.shapes[k], generator=gen) for k in lv.spec.names]
    g_rows.fill_(float("nan"))
    ptr = g_rows.data_ptr()
    torch.cat([gr.reshape(G, -1) for gr in grads] + lv.pad(G), dim=1, out=g_rows)
    assert g_rows.data_ptr() == ptr and not g_rows[:, n:].any()  # packed in place
    g = torch.cat([gr.reshape(G, -1) for gr in grads], dim=1)
    assert torch.equal(g_rows[:, :n], g)
    buf_rows.normal_(generator=gen)
    p_rows[:, n:] = 5.0
    buf_rows[:, n:] = 5.0
    scal = torch.tensor([[7.0, 0.1, 1.0], [3.0, 0.1, 0.0], [1e-6, 0.1, 1.0]])
    p_c, b_c = p_rows[:, :n].clone(), buf_rows[:, :n].clone()
    kw = dict(momentum=0.9, weight_decay=5e-4, max_norm=1.0)
    fused_update.fused_sgd_batched(g_rows[:, :n], p_rows[:, :n], buf_rows[:, :n], lv.mask,
                                   scal, **kw)
    fused_update.fused_sgd_batched(g, p_c, b_c, lv.mask, scal, **kw)
    assert torch.equal(p_rows[:, :n], p_c) and torch.equal(buf_rows[:, :n], b_c)
    assert (p_rows[:, n:] == 5.0).all() and (buf_rows[:, n:] == 5.0).all()
