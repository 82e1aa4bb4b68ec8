"""The data mesh axis of the PyTorch/CUDA port, its pieces on the CPU: the
mesh layout over gloo ranks (``(clients, data)``, rank ``c * data + d``),
the config's refusals, the synchronised batch norm's plain form at two
ranks against the JAX package's ``batch_norm(axis_name="data")`` under
``shard_map`` on ``make_mesh(1, 2)`` (forward and the gradients of x, g
and b), a group of one against the one-rank plain BN bit for bit, and ring
attention at 2 and 4 ranks against the JAX package's ring and dense
attention, in value and in its q, k and v gradients at the JAX package's
own tolerances (``tests/test_ring_attention.py``).  Every rank job runs in
ONE spawn of four gloo ranks (``torch_port_ranks.run_ranks``), each job on
its own ``(world / data, data)`` mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from heterofl_tpu.ops.layers import batch_norm as r_batch_norm
from heterofl_tpu.parallel import make_mesh as r_make_mesh
from heterofl_tpu.parallel.ring_attention import dense_attention as r_dense
from heterofl_tpu.parallel.ring_attention import ring_attention as r_ring
from heterofl_tpu.parallel.round_engine import _shard_map
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.ops import fused_norm
from heterofl_tpu_torch.parallel import mesh as M
from heterofl_tpu_torch.staticcheck.audit import data_step_budget
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture

from torch_port_ranks import run_ranks

few_threads = thread_limit_fixture()

#: the synchronised BN's batch: 8 NHWC samples of 3x3 pixels, 6 channels,
#: two of weight 0 (a padded batch's tail)
BN_N, BN_HW, BN_C = 8, 3, 6
#: ring attention: heads, sequence, head width (tests/test_ring_attention.py)
RING = {2: (2, 32, 8, 3), 4: (4, 32, 16, 0)}  # n -> (h, S, d, seed)
LAYOUTS = [(2, 2), (1, 4), (4, 1)]


def _bn_inputs():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(BN_N, BN_HW, BN_HW, BN_C)).astype(np.float32) * 2 + 0.5
    w = np.ones(BN_N, np.float32)
    w[[3, 7]] = 0.0
    g = rng.normal(size=BN_C).astype(np.float32)
    b = rng.normal(size=BN_C).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    return {"x": x, "w": w, "g": g, "b": b, "dy": dy}


def _bn_reference(a):
    """The JAX package's synchronised BN on ``make_mesh(1, 2)``: ``y``,
    ``dx`` (each shard's local loss differentiated inside the ``shard_map``,
    the round engine's form) and each shard's local ``dg``, ``db``."""
    mesh = r_make_mesh(1, 2)

    def body(x, g, b, w, dy):
        def loss(x, g, b):
            return jnp.sum(r_batch_norm(x, g, b, sample_weight=w, axis_name="data")[0] * dy)

        y = r_batch_norm(x, g, b, sample_weight=w, axis_name="data")[0]
        dx, dg, db = jax.grad(loss, argnums=(0, 1, 2))(x, g, b)
        return y, dx, dg[None], db[None]

    fn = jax.jit(_shard_map(body, mesh, in_specs=(P("data"), P(), P(), P("data"), P("data")),
                            out_specs=(P("data"),) * 4))
    y, dx, dg, db = fn(*(jnp.asarray(a[k]) for k in ("x", "g", "b", "w", "dy")))
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dg": np.asarray(dg),
            "db": np.asarray(db)}


def _ring_inputs(n):
    h, S, d, seed = RING[n]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(h, S, d)).astype(np.float32) for _ in range(3))
    return {"q": q, "k": k, "v": v, "temp": float(np.sqrt(d))}


def _ring_reference(a, n):
    """The JAX package's ring on ``make_mesh(1, n)`` and its dense attention:
    the outputs and the gradients of ``sum(out ** 2)``."""
    mesh, temp = r_make_mesh(1, n), jnp.sqrt(jnp.float32(a["q"].shape[-1]))

    def ring(q, k, v):
        return _shard_map(lambda q_, k_, v_: r_ring(q_, k_, v_, axis_name="data", axis_size=n,
                                                    temperature=temp),
                          mesh, in_specs=(P(None, "data"),) * 3, out_specs=P(None, "data"))(
            q, k, v)

    qkv = tuple(jnp.asarray(a[x]) for x in "qkv")
    out = {"ring": np.asarray(jax.jit(ring)(*qkv)), "dense": np.asarray(r_dense(*qkv, temp))}
    out["ring_grads"] = [np.asarray(g) for g in jax.grad(
        lambda q, k, v: jnp.sum(ring(q, k, v) ** 2), argnums=(0, 1, 2))(*qkv)]
    out["dense_grads"] = [np.asarray(g) for g in jax.grad(
        lambda q, k, v: jnp.sum(r_dense(q, k, v, temp) ** 2), argnums=(0, 1, 2))(*qkv)]
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """ONE spawn of four gloo ranks: the layouts, the synchronised BN at
    ``(2, 2)`` (each clients row the whole batch, split over its two data
    ranks), ring attention at ``(2, 2)`` and ``(1, 4)``; and the JAX
    package's side of each."""
    bn = _bn_inputs()
    rings = {n: _ring_inputs(n) for n in RING}
    jobs = [dict(kind="layout", n_data=d) for _, d in LAYOUTS]
    jobs += [dict(kind="bn_sync", n_data=2, **bn)]
    jobs += [dict(kind="ring", n_data=n, **rings[n]) for n in RING]
    ranks = run_ranks(dict(kind="seq", jobs=jobs), 4, str(tmp_path_factory.mktemp("data_axis")))
    res = [[rk["results"][i] for rk in ranks] for i in range(len(jobs))]
    return {"layouts": dict(zip(LAYOUTS, res[:3])), "bn": (res[3], bn, _bn_reference(bn)),
            "ring": {n: (res[4 + i], _ring_reference(rings[n], n)) for i, n in enumerate(RING)}}


# --- the mesh ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_layout_over_four_ranks(spawned, layout):
    """World rank r sits at clients row ``r // data``, data column ``r %
    data`` (the reference's ``devices.reshape(clients, data)``); the flat
    axis is the world in rank order; a data all-reduce sums its row, a
    clients all-reduce its column, a world all-reduce everything; a ring
    shift brings data rank ``d - 1``'s tensor; the data axis's calls count
    apart from the clients axis's."""
    n_clients, n_data = layout
    for r, out in enumerate(spawned["layouts"][layout]):
        c, d = divmod(r, n_data)
        assert out["coords"] == [c, n_clients, d, n_data, r, 4, r == 0], (layout, r)
        assert out["flat"] == [r, 4]
        assert out["sum_data"] == sum(c * n_data + j for j in range(n_data))
        assert out["sum_clients"] == sum(i * n_data + d for i in range(n_clients))
        assert out["sum_world"] == 6
        assert out["shifted"] == c * n_data + (d - 1) % n_data
        assert out["data_collectives"] == {"all_reduce": 1, "ring_shift": 1,
                                           "ring_shift_host": 0}
        assert out["collectives"]["all_reduce"] == 2  # clients and world


def test_make_mesh_refuses_what_the_world_does_not_hold():
    """On one process (a world of one rank) a data axis of 2 does not divide
    the world, an arms axis is not ported; data 1 is the one-rank mesh,
    whose data axis is a ring of one (a shift hands its tensors back)."""
    with pytest.raises(ValueError, match="data=2 does not divide the world"):
        M.make_mesh(0, 2)
    with pytest.raises(NotImplementedError, match="arms axis"):
        M.make_mesh(0, 1, 2)
    mesh = M.make_mesh(0, 1)
    assert (mesh.data_rank, mesh.data_size, mesh.world_rank, mesh.lead) == (0, 1, 0, True)
    t = torch.arange(3.0)
    assert mesh.ring_shift([t])[0] is t and mesh.flat() is mesh


@pytest.mark.parametrize("strategy", ["grouped", "sliced"])
def test_config_refuses_the_grouped_engines_on_the_data_axis(strategy, monkeypatch):
    """The data axis carries the grouped engine and its sliced twin:
    ``strategy='grouped'`` or ``'sliced'`` is accepted at data 1, at data 2
    and at ``(2, 2)`` under a world of four (``DATA_REFUSALS`` is empty, the
    grouped LM's refusal gone from ``MESH_REFUSALS``).  The refusal
    mechanism stays: an entry of ``DATA_REFUSALS`` still raises
    ``NotImplementedError`` naming its ROADMAP item at data > 1 only."""
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
    cfg.update(data_name="MNIST", model_name="conv", strategy=strategy)
    assert PC.DATA_REFUSALS == ()
    for mesh in ({"clients": 0, "data": 1}, {"clients": 0, "data": 2}):
        PC.process_control(dict(cfg, mesh=mesh))
    monkeypatch.setenv("WORLD_SIZE", "4")
    done = PC.process_control(dict(cfg, mesh={"clients": 2, "data": 2}))
    assert done["mesh"] == {"clients": 2, "data": 2}
    monkeypatch.setattr(PC, "DATA_REFUSALS", ((lambda c: c.get("strategy") == strategy,
                                               f"strategy={strategy!r}", "ROADMAP item x"),))
    PC.process_control(dict(cfg, mesh={"clients": 4, "data": 1}))
    with pytest.raises(NotImplementedError, match=f"strategy='{strategy}' at mesh data=2: "
                                                  r"the data axis does not carry it yet \(ROADMAP"):
        PC.process_control(dict(cfg, mesh={"clients": 2, "data": 2}))


def test_config_refuses_a_window_the_data_axis_does_not_divide():
    """An LM, masked or grouped, at ``data = 3`` with ``bptt`` 64 raises the
    reference's ``ValueError`` (round_engine.py:767-769); ``data = 2`` is
    accepted."""
    for strategy in ("masked", "grouped"):
        cfg = PC.default_cfg()
        cfg["control"] = PC.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
        cfg.update(data_name="WikiText2", model_name="transformer", strategy=strategy)
        PC.process_control(dict(cfg, mesh={"data": 2}))
        with pytest.raises(ValueError, match=r"data axis size \(3\) must divide bptt=64 "
                                             r"for sequence-parallel LM rounds"):
            PC.process_control(dict(cfg, mesh={"data": 3}))


# --- the synchronised batch norm ---------------------------------------------------------

@pytest.mark.parametrize("what", ["y", "dx", "dg", "db"])
def test_sync_batch_norm_at_two_ranks_matches_reference(spawned, what):
    """The plain synchronised BN (``ops.layers.batch_norm(group=)``: the
    stats, the ``[3, C]`` all-reduce, the apply; backward the partial sums,
    the ``[2, C]`` all-reduce, dx) at two data ranks of each clients row
    against the JAX package's ``batch_norm(axis_name="data")`` on
    ``make_mesh(1, 2)``: ``y`` and ``dx`` of each rank's block, and each
    rank's LOCAL ``dg`` and ``db`` (the step's gradient all-reduce sums
    them once; the reduced ones would count them twice).  Tolerance rtol
    and atol 1e-5: the moments are the same one-pass sums in another
    order, and ``dx`` subtracts two terms of the channel's size."""
    outs, bn, ref = spawned["bn"]
    for r, out in enumerate(outs):
        d = r % 2
        got = out[what]
        want = ref[what][d] if what in ("dg", "db") else \
            ref[what][d * BN_N // 2:(d + 1) * BN_N // 2]
        assert_close(f"sync BN {what}, rank {r}", got, want, rtol=1e-5, atol=1e-5)
    if what in ("dg", "db"):  # local: the two ranks' differ, their sum is the batch's
        assert not np.allclose(outs[0][what], outs[1][what])
        np.testing.assert_array_equal(outs[0][what], outs[2][what])


@pytest.mark.parametrize("shape", [(40, 6, 8), (1000, 16, 10), (7, 3, 1)])
def test_sync_batch_norm_group_of_one_is_the_plain_bn_bit_for_bit(shape):
    """With a group of one (no data axis) the split pair's plain versions
    are ``bn_fwd_plain`` and ``bn_bwd_plain`` bit for bit: ``y``, ``stats``,
    ``dx``, and ``dg``/``db`` (the local sums are the batch's); so is
    ``batch_norm_sync`` through the one-rank mesh."""
    M_, C, P_ = shape
    gen = torch.Generator().manual_seed(M_)
    x = torch.randn(M_, C, generator=gen) * 3
    w = (torch.rand(M_ // P_, generator=gen) > 0.3).to(torch.float32)
    g, b, dy = torch.randn(C, generator=gen), torch.randn(C, generator=gen), \
        torch.randn(M_, C, generator=gen)
    y1, st1 = fused_norm.bn_fwd_plain(x, w, P_, g, b)
    y2, st2 = fused_norm.bn_sync_apply_plain(x, g, b, fused_norm.bn_sync_stats_plain(x, w, P_))
    assert torch.equal(y1, y2) and torch.equal(st1, st2)
    dx1, dg1, db1 = fused_norm.bn_bwd_plain(x, w, P_, g, dy, st1)
    loc = fused_norm.bn_sync_bwd_reduce_plain(x, dy, st2)
    dx2 = fused_norm.bn_sync_bwd_apply_plain(x, w, P_, g, dy, st2, loc)
    assert torch.equal(dx1, dx2) and torch.equal(dg1, loc[1]) and torch.equal(db1, loc[0])
    # NCHW (channels_last) samples of P pixels, as a model's site sees them
    hw = {8: (2, 4), 10: (2, 5), 1: (1, 1)}[P_]
    xs = x.view(M_ // P_, *hw, C).permute(0, 3, 1, 2).detach().requires_grad_()
    y3 = fused_norm.batch_norm_sync(xs, g, b, w, M.single_mesh(torch.device("cpu")))
    assert torch.equal(y3.permute(0, 2, 3, 1).reshape(M_, C), y1)
    (dx3,) = torch.autograd.grad((y3 * dy.view(M_ // P_, *hw, C).permute(0, 3, 1, 2)).sum(), xs)
    assert torch.equal(dx3.permute(0, 2, 3, 1).reshape(M_, C), dx1)


def test_sync_kernels_raise_without_a_card_and_plan_by_shape():
    """The four CUDA wrappers refuse a CPU tensor (no fallback on the card);
    the launch plan is a pure function of the shape: chunks of at least 64
    rows, at most 264 blocks, every row in a chunk."""
    x, w = torch.randn(20, 4), torch.ones(2)
    st, glob2 = torch.ones(3, 4), torch.ones(2, 4)
    for call in (lambda: fused_norm.bn_sync_stats_cuda(x, w, 10),
                 lambda: fused_norm.bn_sync_apply_cuda(x, st[0], st[1], st),
                 lambda: fused_norm.bn_sync_bwd_reduce_cuda(x, x, st),
                 lambda: fused_norm.bn_sync_bwd_apply_cuda(x, w, 10, st[0], x, st, glob2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert set(fused_norm.SYNC_LAUNCHES.values()) == {0}
    for M_, C in ((10240, 64), (5120, 64), (80, 512), (1, 1), (999, 33)):
        pl = fused_norm.bn_sync_plan(M_, C)
        assert pl.tiles == -(-C // 32) and pl.tiles * pl.chunks <= max(264, pl.tiles)
        assert pl.rows * pl.chunks >= M_ > pl.rows * (pl.chunks - 1)
        assert pl.rows >= min(M_, 64)


def test_data_step_budget_by_axis():
    """The audit's data-axis budget a local step: a vision step one
    all-reduce and two a BN site, none at data 1; an LM step one and the
    ring's ``(2n - 1)`` shifts a layer."""
    from heterofl_tpu_torch.models import make_model

    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
    cfg.update(data_name="CIFAR10", model_name="resnet18")
    cfg = PC.process_control(cfg)
    cfg["classes_size"] = 10
    r18 = make_model(cfg)
    assert data_step_budget(r18, 1) == {"all_reduce": 0, "ring_shift": 0}
    assert data_step_budget(r18, 2) == {"all_reduce": 1 + 2 * 17, "ring_shift": 0}
    lcfg = PC.default_cfg()
    lcfg["control"] = PC.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
    lcfg.update(data_name="WikiText2", model_name="transformer")
    lcfg = PC.process_control(lcfg)
    lcfg["num_tokens"] = lcfg["classes_size"] = 50
    lm = make_model(lcfg)
    assert data_step_budget(lm, 4) == {"all_reduce": 1, "ring_shift": lm.num_layers * 7}


# --- ring attention ----------------------------------------------------------------------

@pytest.mark.parametrize("n", list(RING))
@pytest.mark.parametrize("against", ["ring", "dense"])
def test_ring_attention_matches_reference(spawned, n, against):
    """The port's ring at ``n`` ranks (each rank its S / n positions)
    against the JAX package's ring on ``make_mesh(1, n)`` and its dense
    attention: rtol/atol 2e-5 (the JAX package's own)."""
    outs, ref = spawned["ring"][n]
    S = ref["dense"].shape[-2]
    for r, out in enumerate(outs):
        d = r % n
        want = ref[against][..., d * S // n:(d + 1) * S // n, :]
        assert_close(f"ring n={n} vs {against}, rank {r}", out["out"], want, rtol=2e-5,
                     atol=2e-5)


@pytest.mark.parametrize("n", list(RING))
@pytest.mark.parametrize("which", [0, 1, 2])
def test_ring_attention_gradients_match_reference(spawned, n, which):
    """q, k and v gradients of ``sum(out ** 2)`` through the port's ring
    backward (``dk``/``dv`` travelling with their block, one more shift home)
    against ``jax.grad`` through the JAX package's ring and through dense
    attention: rtol 5e-4 / atol 5e-5 (the JAX package's own)."""
    outs, ref = spawned["ring"][n]
    S = ref["dense"].shape[-2]
    for r, out in enumerate(outs):
        d = r % n
        for against in ("ring_grads", "dense_grads"):
            want = ref[against][which][..., d * S // n:(d + 1) * S // n, :]
            assert_close(f"ring n={n} grad {'qkv'[which]} vs {against}, rank {r}",
                         out["grads"][which], want, rtol=5e-4, atol=5e-5)
