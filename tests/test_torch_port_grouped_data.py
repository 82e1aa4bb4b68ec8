"""The grouped engine of the PyTorch/CUDA port on the whole mesh, on the CPU:
a level's G clients, each client's batch split over the data ranks of its
clients row, BN synchronised over the data group for the G clients at once
(the batched synchronised pair's plain versions), the grouped LM over
clients and data ranks with ring attention, and the sliced twin at data
2, against the JAX package:

* the batched synchronised BN at two data ranks against the JAX package's
  ``batch_norm(axis_name="data")`` ``jax.vmap``-ped over G = 3 clients
  inside ``_shard_map`` on ``make_mesh(1, 2)`` (forward, and the gradients
  of x, g and b, a zero-weight sample in each client), and at G = 1 equal
  to the one-client pair bit for bit;
* grouped rounds -- the conv net at ``(1, 2)`` and ``(2, 2)`` under
  ``span`` and ``(2, 2)`` under ``slices``, ResNet-18 (8/16/16/16, 40 CIFAR
  images, augmentation on) at ``(1, 2)`` -- against the reference's
  ``GroupedRoundEngine`` on the same ``make_mesh`` with its epoch
  permutations (and each data rank's augmentation draws) handed in;
* the grouped LM round at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)``, dropout 0,
  the reference's whole-window corruption handed in;
* the grouped int8 superstep at ``(1, 2)`` against the reference's, the
  codec's one participant the clients row;
* the superstep equal to its K sequential rounds bit for bit (its steps
  eager at data > 1), the ranks bit for bit equal with the data group's
  collectives ``data_step_budget`` a level step, the sliced twin at data 2
  equal to its one-rank run, and the grouped entry at ``(1, 2)`` resumed
  bit for bit.

Tolerances are the masked data axis's (``tests/test_torch_port_data_mesh.py``):
params atol 5e-5, ``n`` and rates exact, the metric sums rtol/atol 1e-4;
the BN's rtol/atol 1e-5.  The rank jobs run in ONE spawn of two gloo ranks
(the ``(1, 2)`` and ``(2, 1)`` meshes: a mesh spans the whole world) and
ONE of four (``(2, 2)``); the one-rank runs go in this process."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from heterofl_tpu import config as RC
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.layers import batch_norm as r_batch_norm
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.parallel.round_engine import _shard_map
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import flat_from_jax, params_from_jax
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine
from heterofl_tpu_torch.parallel.mesh import Mesh, single_mesh
from heterofl_tpu_torch.staticcheck.audit import data_step_budget
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from heterofl_tpu_torch.utils import load_checkpoint

from test_torch_port_grouped import _cfg, _vision_data, assert_grouped_matches
from test_torch_port_lm import BPTT, SMALL, draws_of
from test_torch_port_lm import _cfg as lm_cfg
from test_torch_port_round import reference_draws
from torch_port_ranks import grouped_job, run_ranks

few_threads = thread_limit_fixture()

LR = 0.05
CPU = torch.device("cpu")
CONTROL = "1_4_1_iid_fix_a2-e2_bn_1_1"  # users 0, 1 at level a; 2, 3 at level e
USERS = np.arange(4)
RESNET = "1_3_1_iid_fix_a2-e1_bn_1_1"
LM_CONTROL = "1_4_1_iid_fix_a2-b1-c1_bn_1_1"
NO_DROP = {"transformer": {**SMALL["transformer"], "dropout": 0.0}}
SS_CONTROL = "1_6_1_iid_fix_a2-c2-e2_bn_1_1"
SS_USERS = np.array([[0, 2, 3, 5], [1, 4, 0, 3]])
EPOCH0 = 3
#: the int8 superstep at (1, 2) against the reference: at most this share of
#: entries one grid step apart (chip_smoke.py's DATA_INT8_SHARE)
DATA_INT8_SHARE = 0.02
#: the batched synchronised BN's inputs: G clients of 8 NHWC samples of 3x3
#: pixels, 4 channels each, one sample of weight 0 in each client
BN_G, BN_N, BN_HW, BN_C = 3, 8, 3, 4


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).ravel() for k in sorted(tree)])


def _init(rcfg):
    return {k: np.asarray(v) for k, v in r_make_model(rcfg).init(jax.random.key(0)).items()}


# --- the batched synchronised batch norm ---------------------------------------------------

def _bn_inputs(G):
    rng = np.random.default_rng(13 + G)
    x = rng.normal(size=(G, BN_N, BN_HW, BN_HW, BN_C)).astype(np.float32) * 2 + 0.5
    w = np.ones((G, BN_N), np.float32)
    for g in range(G):
        w[g, (3 + 2 * g) % BN_N] = 0.0
    return {"x": x, "w": w, "g": rng.normal(size=(G, BN_C)).astype(np.float32),
            "b": rng.normal(size=(G, BN_C)).astype(np.float32),
            "dy": rng.normal(size=x.shape).astype(np.float32)}


def _bn_reference(a):
    """The JAX package's synchronised BN ``jax.vmap``-ped over the G clients
    inside ``_shard_map`` on ``make_mesh(1, 2)`` (the grouped engine's form,
    ref grouped.py:495-529): ``y``, ``dx`` and each shard's local ``dg``,
    ``db`` ``[2, G, C]``."""
    mesh = make_mesh(1, 2)

    def body(x, g, b, w, dy):
        def one(x, g, b, w, dy):
            def loss(x, g, b):
                return jnp.sum(r_batch_norm(x, g, b, sample_weight=w, axis_name="data")[0] * dy)

            y = r_batch_norm(x, g, b, sample_weight=w, axis_name="data")[0]
            return (y,) + jax.grad(loss, argnums=(0, 1, 2))(x, g, b)

        y, dx, dg, db = jax.vmap(one)(x, g, b, w, dy)
        return y, dx, dg[None], db[None]

    split = P(None, "data")
    fn = jax.jit(_shard_map(body, mesh, in_specs=(split, P(), P(), split, split),
                            out_specs=(split, split, P("data"), P("data"))))
    y, dx, dg, db = fn(*(jnp.asarray(a[k]) for k in ("x", "g", "b", "w", "dy")))
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dg": np.asarray(dg),
            "db": np.asarray(db)}


# --- the reference's rounds on its meshes ---------------------------------------------------

def _reference_round(rcfg, arrays, users, mesh, key, lr=LR, params=None):
    params = _init(rcfg) if params is None else params
    eng = RGroupedRoundEngine(rcfg, make_mesh(*mesh))
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in params.items()},
                                  np.asarray(users, np.int32), rates,
                                  tuple(jnp.asarray(a) for a in arrays), lr, jax.random.key(key))
    return params, ({k: np.asarray(v) for k, v in r_new.items()},
                    {k: np.asarray(v) for k, v in r_ms.items()}, dict(eng._slices))


def _data_aug_draws(key, users, B, steps, n_data):
    """Each client's step-``t`` augmentation as the reference draws it on
    the data axis (round_engine.py:700-710: data rank ``d`` augments its
    ``B / n_data`` rows from ``fold_in(aug_key, d)``), the ranks' draws
    concatenated into the whole batch's, as the port's ``aug_draws`` takes
    them."""
    slot_keys = client_stream_keys(key, jnp.asarray(users))
    b_loc, out = -(-B // n_data), {}
    for i, u in enumerate(np.asarray(users).tolist()):
        for t in range(steps):
            parts = []
            for d in range(n_data):
                k_shift, k_flip = jax.random.split(
                    jax.random.fold_in(jax.random.fold_in(slot_keys[i], 2 + t), d))
                parts.append((np.asarray(jax.random.randint(k_shift, (b_loc, 2), 0, 9)),
                              np.asarray(jax.random.bernoulli(k_flip, 0.5, (b_loc,)))))
            out[u, t] = tuple(np.concatenate([p[j] for p in parts])[:B] for j in (0, 1))
    return out


def _conv_case(mesh, placement="span"):
    rcfg = dict(_cfg(RC, CONTROL), level_placement=placement)
    pcfg = dict(_cfg(PC, CONTROL), level_placement=placement,
                strict_placement=placement == "slices")
    arrays = _vision_data("MNIST", 4, 160)
    params, ref = _reference_round(rcfg, arrays, USERS, mesh, 3)
    perms, _ = reference_draws(jax.random.key(3), USERS, rcfg["num_epochs"]["local"],
                               arrays[0].shape[1])
    job = dict(kind="grouped", cfg=pcfg, params=params, data=arrays, users=USERS, lr=LR,
               epoch_perms=perms, n_data=mesh[1])
    return job, ref


def _resnet_case():
    """ResNet-18 at 8/16/16/16, two level-a clients and one level-e client
    of 40 CIFAR images (2 steps each, batch 10, 5 a data rank), augmentation
    on, at ``(1, 2)``.  The round is chaotic past a few steps: at 120 images
    (4 steps) the reference's own round on ``make_mesh(1, 2)`` moves 7.6e-4
    on params under a 1e-6 relative change of its init, at 40 images 2.7e-5
    (``scripts/grouped_data_band.py``)."""
    rcfg = _cfg(RC, RESNET, "resnet18", "CIFAR10", local=1)
    pcfg = _cfg(PC, RESNET, "resnet18", "CIFAR10", local=1)
    arrays = _vision_data("CIFAR10", 3, 40)
    users = np.arange(3)
    params, ref = _reference_round(rcfg, arrays, users, (1, 2), 3)
    B, N = rcfg["batch_size"]["train"], arrays[0].shape[1]
    perms, _ = reference_draws(jax.random.key(3), users, 1, N)
    aug = _data_aug_draws(jax.random.key(3), users, B, -(-N // B), 2)
    job = dict(kind="grouped", cfg=pcfg, params=params, data=arrays, users=users, lr=LR,
               epoch_perms=perms, aug_draws=aug, n_data=2)
    return job, ref


def _lm_rows():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, size=(4, 2, 40)).astype(np.int64)
    lm = np.ones((4, 50), np.float32)
    lm[3, ::4] = 0.0
    return rows, lm


def _lm_case(mesh):
    """The grouped LM round (levels a, b, c; dropout 0) on ``mesh``, the
    reference's whole-window corruption handed in."""
    rcfg, pcfg = lm_cfg(RC, LM_CONTROL, **NO_DROP), lm_cfg(PC, LM_CONTROL, **NO_DROP)
    rows, lm = _lm_rows()
    params, ref = _reference_round(rcfg, (rows, lm), USERS, mesh, 7)
    slot_keys = client_stream_keys(jax.random.key(7), jnp.asarray(USERS))
    steps = pcfg["num_epochs"]["local"] * -(-rows.shape[2] // BPTT)
    draws = {(int(u), t): {"corrupt": draws_of(jax.random.fold_in(slot_keys[i], 5000 + t),
                                               rows.shape[1], BPTT, train=False)["corrupt"]}
             for i, u in enumerate(USERS) for t in range(steps)}
    job = dict(kind="grouped", cfg=pcfg, params=params, data=(rows, lm), users=USERS, lr=LR,
               lm_draws=draws, n_data=mesh[1])
    return job, ref, steps


def _ss_cfg(mod):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(SS_CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, wire_codec="int8",
               error_feedback=True, strategy="grouped", superstep_rounds=2,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}})
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def _int8_case():
    """The grouped int8 superstep (two rounds from ``EPOCH0``, key 7) on
    ``make_mesh(1, 2)``: one participant (the clients row), the reference's
    noise of clients index 0 and its client draws handed to both data
    ranks."""
    rcfg, pcfg = _ss_cfg(RC), _ss_cfg(PC)
    arrays = _vision_data("MNIST", 6, 120)
    params = _init(rcfg)
    rates = np.asarray(rcfg["model_rate"], np.float32)[SS_USERS]
    k, base = SS_USERS.shape[0], jax.random.key(7)
    reng = RGroupedRoundEngine(rcfg, make_mesh(1, 2))
    r_new, pend = reng.train_superstep({n: jnp.asarray(v) for n, v in params.items()}, base,
                                       EPOCH0, k, SS_USERS, rates,
                                       tuple(jnp.asarray(a) for a in arrays), lr=LR)
    r_rounds = pend.fetch()
    eng = GroupedRoundEngine(make_model(pcfg), pcfg, CPU)
    perms = make_model(pcfg).jax_perms()
    flat = eng.spec.flatten(params_from_jax({n: np.asarray(v) for n, v in r_new.items()}, perms))
    keys = [jax.random.fold_in(base, EPOCH0 + r) for r in range(k)]
    draws = [reference_draws(key, SS_USERS[r], 1, arrays[0].shape[1])[0]
             for r, key in enumerate(keys)]
    noise = [flat_from_jax(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0), (eng.spec.total,),
        jnp.float32)), eng.spec.shapes, perms) for key in keys]
    job = dict(kind="grouped", cfg=pcfg, params=params, data=arrays, users=SS_USERS, rates=rates,
               k=k, seed=0, epoch0=EPOCH0, lr=LR, epoch_perms=draws, first_round=True,
               codec_noise=[noise], n_data=2)
    return job, (flat.numpy(), [{n: np.asarray(v) for n, v in r.items()} for r in r_rounds])


def _superstep_case():
    pcfg = _cfg(PC, CONTROL, local=1)
    model = make_model(pcfg)
    from heterofl_tpu_torch.convert import params_to_jax

    params = params_to_jax(model.init_(torch.Generator().manual_seed(0)).params(),
                           model.jax_perms())
    users = np.array([[0, 1, 2, 3], [3, 1, 0, 2]])
    rates = np.asarray(pcfg["model_rate"], np.float32)[users]
    return dict(kind="superstep", engine="grouped", cfg=pcfg,
                params={k: np.asarray(v) for k, v in params.items()},
                data=_vision_data("MNIST", 4, 80), users=users, rates=rates, lr=LR, k=2,
                n_data=2)


def _entry_argv(out_dir, rounds, resume=0):
    return ["--device", "cpu", "--control_name", "1_8_0.5_iid_fix_a1-e1_bn_1_1", "--data_name",
            "MNIST", "--model_name", "conv", "--synthetic", "1", "--synthetic_sizes",
            '{"train": 160, "test": 40}', "--strategy", "grouped", "--superstep_rounds", "2",
            "--resume_mode", str(resume), "--output_dir", out_dir,
            "--mesh", json.dumps({"clients": 1, "data": 2}), "--override",
            json.dumps({"num_epochs": {"global": rounds, "local": 1},
                        "conv": {"hidden_size": [4, 8]}})]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The reference side of every case, ONE spawn of two gloo ranks (the
    ``(1, 2)`` and ``(2, 1)`` jobs, the entry) and ONE of four (``(2, 2)``),
    each running its jobs in turn under deterministic algorithms."""
    out = tmp_path_factory.mktemp("grouped_data")
    bn = {G: _bn_inputs(G) for G in (BN_G, 1)}
    two = {"conv": _conv_case((1, 2)), "resnet": _resnet_case(), "lm_21": _lm_case((2, 1)),
           "lm_12": _lm_case((1, 2)), "int8": _int8_case(),
           "superstep": (_superstep_case(), None)}
    for G in bn:
        two[f"bn{G}"] = (dict(kind="bn_sync_clients", n_data=2, **bn[G]),
                         _bn_reference(bn[G]) if G > 1 else None)
    conv_job = two["conv"][0]
    two["twin"] = (dict(conv_job, cfg=dict(conv_job["cfg"], strategy="sliced"), engine="sliced"),
                   None)
    full, part = str(out / "full"), str(out / "part")
    entry = dict(kind="entry", entry="train_classifier_fed", n_data=2)
    for name, argv in (("full", _entry_argv(full, 4)), ("part", _entry_argv(part, 2)),
                       ("resumed", _entry_argv(part, 4, resume=1))):
        two[name] = (dict(entry, argv=argv), None)
    four = {"conv": _conv_case((2, 2)), "slices": _conv_case((2, 2), "slices"),
            "lm": _lm_case((2, 2))}
    res = {"dir": {"full": full}, "jobs": {2: {k: c[0] for k, c in two.items()},
                                           4: {k: c[0] for k, c in four.items()}}}
    for n, cases in ((2, two), (4, four)):
        ranks = run_ranks(dict(kind="seq", deterministic=True, jobs=[c[0] for c in cases.values()]),
                          n, str(out / f"w{n}"), timeout_s=600)
        assert all(rk["foreign_modules"] == [] for rk in ranks)  # the rank jobs load no JAX
        res[n] = {name: ([rk["results"][i] for rk in ranks],) + tuple(cases[name][1:])
                  for i, name in enumerate(cases)}
    return res


def _one_rank(job):
    """The job on one rank without a group, on one thread under
    deterministic algorithms as the ranks run it (``slices`` falls back to
    ``span`` there)."""
    cfg = dict(job["cfg"], level_placement="span", strict_placement=False)
    threads, det = torch.get_num_threads(), torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    try:
        return grouped_job(dict(job, cfg=cfg), single_mesh(CPU), torch)
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(det)


def _ranks_equal(case, outs):
    for r, out in enumerate(outs[1:], start=1):
        assert np.array_equal(out["flat"], outs[0]["flat"]), f"{case}: rank {r} params"
        rounds = out["round"] if isinstance(out["round"], list) else [out["round"]]
        first = outs[0]["round"] if isinstance(outs[0]["round"], list) else [outs[0]["round"]]
        for a, b in zip(rounds, first):
            for k in ("loss_sum", "score_sum", "n"):
                assert np.array_equal(a[k], b[k]), f"{case}: rank {r} {k}"


# --- the batched synchronised batch norm ---------------------------------------------------

@pytest.mark.parametrize("what", ["y", "dx", "dg", "db"])
def test_batched_sync_batch_norm_at_two_ranks_matches_reference(spawned, what):
    """The batched plain synchronised BN (``fused_norm.batch_norm_sync_clients``:
    the batched stats, the ``[3, G*C]`` all-reduce, the apply; backward the
    partial sums, the ``[2, G*C]`` all-reduce, the batched dx) of G = 3
    clients at two data ranks against the JAX package's
    ``batch_norm(axis_name="data")`` under ``jax.vmap`` on ``make_mesh(1,
    2)``: ``y`` and ``dx`` of each rank's block, each rank's LOCAL ``dg`` and
    ``db``, rtol/atol 1e-5 (the one-client pair's tolerance); two
    all-reduces over the data group."""
    outs, ref = spawned[2][f"bn{BN_G}"]
    half = BN_N // 2
    for d, out in enumerate(outs):
        want = ref[what][d] if what in ("dg", "db") else ref[what][:, d * half:(d + 1) * half]
        assert_close(f"batched sync BN {what}, G {BN_G}, data rank {d}", out[what], want,
                     rtol=1e-5, atol=1e-5)
        assert out["data_collectives"]["all_reduce"] == 2
    if what in ("dg", "db"):  # local: the two ranks' differ
        assert not np.allclose(outs[0][what], outs[1][what])


def test_batched_sync_batch_norm_at_one_client_is_the_one_client_pair(spawned):
    """At G = 1 the batched pair is the one-client synchronised pair bit for
    bit at two data ranks: ``y``, ``dx`` and the local ``dg``, ``db``."""
    outs, _ = spawned[2]["bn1"]
    for out in outs:
        for what in ("y", "dx", "dg", "db"):
            np.testing.assert_array_equal(out[what], out["one"][what], err_msg=what)


@pytest.mark.parametrize("shape", [(40, 2, 8, 4), (1000, 3, 16, 10), (999, 4, 3, 111)])
def test_batched_sync_plain_pair_by_client(shape):
    """The batched plain pair against the one-client pair on each client's
    columns (G clients, ragged widths included): equal to the one-client
    sums and dx client by client, within float rounding; the wrappers take
    the plain versions on the CPU and the CUDA wrappers refuse a CPU tensor."""
    from heterofl_tpu_torch.ops import fused_norm

    M_, G, C, P_ = shape
    gen = torch.Generator().manual_seed(M_)
    x = torch.randn(M_, G * C, generator=gen) * 2 + 0.5
    w = (torch.rand(G, M_ // P_, generator=gen) > 0.2).to(torch.float32)
    g, dy = torch.randn(G * C, generator=gen), torch.randn(M_, G * C, generator=gen)
    loc = fused_norm.bn_sync_stats_batched(x, w, P_)
    _, stats = fused_norm.bn_sync_apply(x, g, g, loc)
    red = fused_norm.bn_sync_bwd_reduce(x, dy, stats)
    dx = fused_norm.bn_sync_bwd_apply_batched(x, w, P_, g, dy, stats, red)
    for c in range(G):
        cols = slice(c * C, (c + 1) * C)
        one = fused_norm.bn_sync_stats_plain(x[:, cols], w[c], P_)
        assert_close(f"batched stats, client {c}", loc[:, cols], one, rtol=1e-6, atol=1e-4)
        dx1 = fused_norm.bn_sync_bwd_apply_plain(x[:, cols], w[c], P_, g[cols], dy[:, cols],
                                                 stats[:, cols], red[:, cols])
        assert_close(f"batched dx, client {c}", dx[:, cols], dx1, rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_norm.bn_sync_stats_batched_cuda(x, w, P_)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_norm.bn_sync_bwd_apply_batched_cuda(x, w, P_, g, dy, stats, red)
    assert fused_norm.SYNC_LAUNCHES["bn_sync_stats_batched"] == 0


# --- grouped rounds against the reference's meshes ----------------------------------------

VISION = [(2, "conv"), (2, "resnet"), (4, "conv"), (4, "slices")]


@pytest.mark.parametrize("world,case", VISION)
def test_grouped_round_on_the_data_axis_matches_reference_mesh(spawned, world, case):
    """The grouped K=1 round with each client's batch split over two data
    ranks, BN synchronised for the level's clients at once: the conv net at
    ``(1, 2)`` and ``(2, 2)`` under span and ``(2, 2)`` under slices (level
    a on clients row 0, level e on row 1), ResNet-18 with CIFAR
    augmentation at ``(1, 2)`` (each data rank's crop and flip draws), each
    against the reference's ``GroupedRoundEngine`` on the same
    ``make_mesh``: params atol 5e-5, ``n`` and rates exact, the sums
    rtol/atol 1e-4; the slices table the reference's."""
    outs, (r_new, r_ms, r_slices) = spawned[world][case]
    mesh = f"({world // 2}, 2)"
    for out in outs:
        assert_grouped_matches(f"grouped {case} round at {mesh}", out["params"], out["round"],
                               r_new, r_ms)
    assert outs[0]["slices"] == {float(r): tuple(int(x) for x in lh)
                                 for r, lh in r_slices.items()}
    assert outs[0]["placement"] == ("slices" if case == "slices" else "span")


#: each clients row's (level, G, level steps) of a case
ROW_LEVELS = {(2, "conv"): [[(1.0, 2, 8), (0.0625, 2, 8)]],
              (2, "resnet"): [[(1.0, 2, 2), (0.0625, 1, 2)]],
              (4, "conv"): [[(1.0, 1, 8), (0.0625, 1, 8)]] * 2,
              (4, "slices"): [[(1.0, 2, 8)], [(0.0625, 2, 8)]]}


@pytest.mark.parametrize("world,case", VISION)
def test_grouped_data_ranks_are_bit_for_bit_equal_and_count_by_axis(spawned, world, case):
    """Every rank ends the round with rank 0's params and metric rows bit
    for bit; the clients group makes one all-reduce and one gather a round;
    the data group one all-reduce a level step and two a BN site for the
    level's clients at once (the audit's ``data_step_budget``), no ring
    shift, carrying ``staticcheck.wire.data_step_bytes`` a level step: the
    packed ``[G, ld]`` gradient with the ``[G, 2]`` sums, ``[3, G*C]`` and
    ``[2, G*C]`` a site."""
    from heterofl_tpu_torch.staticcheck.wire import data_step_bytes

    outs = spawned[world][case][0]
    _ranks_equal(f"grouped {case} at {world} ranks", outs)
    job_cfg = spawned["jobs"][world][case]["cfg"]
    per = data_step_budget(make_model(job_cfg), 2)
    eng = GroupedRoundEngine(make_model(job_cfg), dict(job_cfg, level_placement="span"), CPU)
    for r, out in enumerate(outs):
        levels = ROW_LEVELS[world, case][r // 2]
        steps = sum(n for _, _, n in levels)
        nbytes = sum(n * data_step_bytes(G, eng.levels[rate].ld, [
            s[0] for k, s in eng.levels[rate].spec.shapes.items() if k.endswith(".g")])
            for rate, G, n in levels)
        assert (out["collectives"]["all_reduce"], out["collectives"]["gather"]) == (1, 1)
        assert out["data_collectives"] == {"all_reduce": steps * per["all_reduce"],
                                           "ring_shift": 0, "ring_shift_host": 0}
        assert out["data_collective_bytes"]["all_reduce"] == nbytes


@pytest.mark.parametrize("world,case", [(2, "conv"), (4, "conv")])
def test_grouped_round_on_the_data_axis_against_one_rank(spawned, world, case):
    """The data-split round against the one-rank round (no group): within
    5e-5 on params, the metric rows within rtol/atol 1e-5 (each BN site's
    moments are the same sums in another order)."""
    outs = spawned[world][case][0]
    one = _one_rank(spawned["jobs"][world][case])
    assert_close(f"grouped conv at {world} ranks vs one rank: params", outs[0]["flat"],
                 one["flat"], rtol=0, atol=5e-5)
    for k in ("loss_sum", "score_sum", "n"):
        assert_close(f"grouped conv at {world} ranks vs one rank: {k}", outs[0]["round"][k],
                     one["round"][k], rtol=1e-5, atol=1e-5)


# --- the grouped LM over clients and data ranks --------------------------------------------

LM_MESHES = [(2, "lm_21"), (2, "lm_12"), (4, "lm")]


@pytest.mark.parametrize("world,case", LM_MESHES)
@pytest.mark.parametrize("what", ["params", "counts", "sums", "ranks"])
def test_grouped_lm_round_on_the_mesh_matches_reference(spawned, world, case, what):
    """The grouped LM round (levels a, b, c; dropout 0) at ``(2, 1)``, ``(1,
    2)`` and ``(2, 2)`` -- on the data axis each rank 8 of the 16 positions
    of every window, ring attention over the data group with the level's
    clients folded into its leading axes, the position count reduced with
    the gradient -- against the reference's on the same ``make_mesh`` with
    its whole-window corruption: params atol 5e-5, ``n`` exactly, sums
    rtol/atol 1e-4; the ranks bit for bit equal, one all-reduce and ``L (2n
    - 1)`` ring shifts a level step on the data group."""
    outs, (r_new, r_ms, _), steps = spawned[world][case]
    name = {"lm_21": "(2, 1)", "lm_12": "(1, 2)", "lm": "(2, 2)"}[case]
    if what == "params":
        for out in outs:
            assert_close(f"grouped LM round {name}: params", _flat(out["params"]), _flat(r_new),
                         rtol=0, atol=5e-5)
    elif what == "counts":
        np.testing.assert_array_equal(outs[0]["round"]["n"], r_ms["n"])
        np.testing.assert_array_equal(outs[0]["round"]["rate"], r_ms["rate"])
    elif what == "sums":
        for k in ("loss_sum", "score_sum"):
            assert_close(f"grouped LM round {name}: {k}", outs[0]["round"][k], r_ms[k],
                         rtol=1e-4, atol=1e-4)
    else:
        _ranks_equal(f"grouped LM at {name}", outs)
        n_data = 1 if case == "lm_21" else 2
        # level steps of a clients row: (1, 2) runs levels a, b, c; under
        # (2, 2) row 0 holds a, b and c, row 1 one level-a client
        levels = {0: 3, 1: 1} if case == "lm" else {0: 3}
        L = SMALL["transformer"]["num_layers"]
        for r, out in enumerate(outs):
            n = levels.get(r // n_data, 3) * steps
            want = {"all_reduce": n, "ring_shift": n * L * 3} if n_data > 1 else \
                {"all_reduce": 0, "ring_shift": 0}
            assert {k: out["data_collectives"][k] for k in want} == want


# --- the superstep, the codec, the twin, the entry ----------------------------------------

def test_grouped_int8_superstep_on_the_data_axis_matches_reference_mesh(spawned):
    """The grouped int8 superstep (two rounds, levels a, c, e) at ``(1, 2)``
    against the reference's on ``make_mesh(1, 2)``: the codec's one
    participant is the clients row, its noise the reference's of clients
    index 0, so both data ranks encode the same payload; params within 5e-5
    but at most ``DATA_INT8_SHARE`` of entries one grid step ``s / count``
    apart, round 2's ``n`` exactly and sums rtol/atol 1e-4; the ranks bit
    for bit equal."""
    outs, (r_flat, r_rounds) = spawned[2]["int8"]
    _ranks_equal("grouped int8 superstep at (1, 2)", outs)
    pcfg = _ss_cfg(PC)
    eng = GroupedRoundEngine(make_model(pcfg), pcfg, CPU)
    arrays = _vision_data("MNIST", 6, 120)
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    rates = np.asarray(pcfg["model_rate"], np.float32)[SS_USERS]
    P1, cmax = torch.from_numpy(outs[0]["first"]), eng.codec_slots(rates)
    counts = torch.zeros_like(P1)
    for u, rate in zip(SS_USERS[1], rates[1]):
        lv = eng.levels[float(rate)]
        counts.index_add_(0, lv.idx, lv.count_masks(data[-1][[int(u)]])[0])
    step = eng.codec.scale_flat(P1, cmax)
    assert_grid_close("grouped int8 superstep (1, 2): params", outs[0]["flat"], r_flat,
                      torch.where(counts > 0, step / counts.clamp_min(1), 0.0), atol=5e-5,
                      max_share=DATA_INT8_SHARE)
    for r, (got, want) in enumerate(zip(outs[0]["round"], r_rounds)):
        np.testing.assert_array_equal(got["n"], want["n"])
        for k in ("loss_sum", "score_sum"):
            assert_close(f"grouped int8 superstep (1, 2) round {r}: {k}", got[k], want[k],
                         rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("what", ["params", "rows"])
def test_grouped_superstep_equals_sequential_rounds_on_the_data_axis(spawned, what):
    """At ``(1, 2)`` the grouped superstep of two rounds (its level steps
    eager: a step holds gloo collectives) equals the two rounds through
    ``train_round`` bit for bit, on every rank: params and each round's
    metric rows."""
    outs = spawned[2]["superstep"][0]
    for out in outs:
        if what == "params":
            np.testing.assert_array_equal(out["superstep"], out["seq"])
        else:
            for a, b in zip(out["superstep_rows"], out["seq_rows"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(outs[0]["superstep"], outs[1]["superstep"])


def test_sliced_twin_on_the_data_axis_is_its_one_rank_run(spawned):
    """At ``(1, 2)`` every rank runs the sliced twin whole, with no
    collective: each rank's round is the one-rank round bit for bit."""
    outs = spawned[2]["twin"][0]
    one = _one_rank(spawned["jobs"][2]["twin"])
    for out in outs:
        np.testing.assert_array_equal(out["flat"], one["flat"])
        assert out["data_collectives"]["all_reduce"] == 0


def test_grouped_entry_on_the_data_axis_resumes_bit_for_bit(spawned):
    """``train_classifier_fed --strategy grouped --mesh '{"clients": 1,
    "data": 2}'`` (supersteps of two): 4 rounds uninterrupted against 2 then
    a resumed superstep -- params and records bit for bit on both ranks;
    the header records ``(clients, data)`` beside the grouped layout; a
    resume under another layout is refused."""
    from heterofl_tpu_torch.entry.common import check_mesh_layout

    a, b = spawned[2]["full"][0], spawned[2]["resumed"][0]
    for r in range(2):
        for k in a[r]["params"]:
            np.testing.assert_array_equal(a[r]["params"][k], b[r]["params"][k], err_msg=k)
            np.testing.assert_array_equal(a[r]["params"][k], a[0]["params"][k], err_msg=k)
        assert [h["loss"] for h in b[r]["history"]] == [h["loss"] for h in a[r]["history"][2:]]
        assert a[r]["data_collectives"]["all_reduce"] > 0
    (path,) = glob.glob(os.path.join(spawned["dir"]["full"], "model", "*_checkpoint.pkl"))
    header = load_checkpoint(path)
    layout = header["mesh_layout"]
    assert layout["mesh"] == [1, 2] and layout["ranks"] == 1
    assert layout["level_placement"] == "span"
    check_mesh_layout(header, layout, Mesh(rank=0, size=1, device=CPU, data_size=2))
    with pytest.raises(ValueError, match="resume at the checkpoint's layout"):
        check_mesh_layout(header, dict(layout, mesh=None), Mesh(rank=0, size=1, device=CPU))
