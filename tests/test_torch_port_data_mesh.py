"""The data mesh axis of the PyTorch/CUDA port end to end, at two and four
gloo ranks on the CPU (``torch_port_ranks.run_ranks``: every case's job in
turn in ONE spawn of two ranks, mesh ``(1, 2)``, and ONE of four, mesh
``(2, 2)``), under deterministic algorithms, against the JAX package:

* the masked MNIST conv round at ``(1, 2)`` and ``(2, 2)`` against the
  reference's ``RoundEngine`` on ``make_mesh(1, 2)`` and ``make_mesh(2,
  2)`` with its epoch permutations handed in: params within atol 5e-5 (the
  round contract), ``n`` and the rates exactly, the metric sums within
  rtol/atol 1e-4; every rank bit for bit rank 0's; the data group's
  collectives one all-reduce a step and two a BN site;
* the masked LM round at ``(2, 2)`` against ``make_mesh(2, 2)``, dropout 0,
  the reference's corruption handed in (each rank slices its positions of
  the whole window's draw), ring attention over the data group;
* ``data_placement='sharded'`` at ``(2, 2)``: a clients row's users held
  by both its data ranks, against the reference's sharded round;
* int8 at ``(1, 2)``: the codec's participant is the clients row, so both
  data ranks quantise the same payload with the reference's noise;
* ``SeqParallelLM.forward`` and ``train_step`` at ``(1, 2)`` against the
  JAX package's ``SeqParallelLM`` on ``make_mesh(1, 2)``;
* the superstep equal to its K sequential rounds bit for bit at ``(1, 2)``
  (its steps run eagerly at data > 1);
* the sharded evaluation over the flat ``("clients", "data")`` axis against
  one rank, and the entry at ``(2, 2)``: a sharded checkpoint (one shard a
  clients row, written by its data column 0) resumed equals the
  uninterrupted run bit for bit, its header recording the layout."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.parallel import shard_client_data as r_shard_client_data
from heterofl_tpu.parallel.long_context import SeqParallelLM as RSeqParallelLM
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress import make_codec
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.entry.common import check_mesh_layout
from heterofl_tpu_torch.fed.core import to_width_rates
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import RoundEngine
from heterofl_tpu_torch.parallel import mesh as M
from heterofl_tpu_torch.staticcheck.audit import data_step_budget
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint
from heterofl_tpu_torch.utils.checkpoint import SHARD_SET_KEY

from test_torch_port_lm import BPTT, MR, SMALL, _round_data, draws_of, ref_model  # noqa: F401
from test_torch_port_lm import LR as LM_LR
from test_torch_port_lm import _cfg as lm_cfg
from test_torch_port_pod import _eval_cases
from test_torch_port_round import LR, _cfg, _data, reference_draws
from torch_port_ranks import _eval_job, run_ranks

few_threads = thread_limit_fixture()

USERS = np.array([0, 1, 2, 3])
KEY = 3
#: the LM cases' config: the small transformer with dropout 0
NO_DROP = {"transformer": {**SMALL["transformer"], "dropout": 0.0}}


def _flat(params):
    return np.concatenate([np.asarray(params[k]).ravel() for k in sorted(params)])


def _reference(rcfg, arrays, users, n_clients, key=KEY):
    """One reference round on ``make_mesh(n_clients, 2)`` from its key-0
    init -> (initial params, new params, metrics, residual)."""
    rmodel = r_make_model(rcfg)
    params = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    eng = RRoundEngine(rmodel, rcfg, make_mesh(n_clients, 2))
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in params.items()},
                                  jax.random.key(key), LR, np.asarray(users),
                                  tuple(jnp.asarray(a) for a in arrays))
    return (params, {k: np.asarray(v) for k, v in r_new.items()},
            {k: np.asarray(v) for k, v in r_ms.items()}, eng.wire_resid_host())


def _conv_case(n_clients):
    rcfg, pcfg = _cfg(RC), _cfg(PC)
    arrays = _data()
    params, r_new, r_ms, _ = _reference(rcfg, arrays, USERS, n_clients)
    perms, _ = reference_draws(jax.random.key(KEY), USERS, rcfg["num_epochs"]["local"],
                               arrays[0].shape[1])
    job = dict(kind="round", cfg=pcfg, params=params, data=arrays, users=USERS, lr=LR,
               epoch_perms=perms)
    return job, (r_new, r_ms, pcfg, arrays)


def _sharded_case():
    """``data_placement='sharded'`` at ``(2, 2)``: the users padded and split
    over the clients rows, every data rank of a row holding its row's
    block; against the reference's sharded round on ``make_mesh(2, 2)``."""
    rcfg = dict(_cfg(RC), data_placement="sharded")
    pcfg = dict(_cfg(PC), data_placement="sharded")
    arrays = _data()
    users = np.array([3, 0, 2, 1])  # owners 1, 0, 1, 0
    rmodel = r_make_model(rcfg)
    params = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    mesh = make_mesh(2, 2)
    eng = RRoundEngine(rmodel, rcfg, mesh)
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in params.items()},
                                  jax.random.key(KEY), LR, users,
                                  r_shard_client_data(mesh, arrays))
    perms, _ = reference_draws(jax.random.key(KEY), users, rcfg["num_epochs"]["local"],
                               arrays[0].shape[1])
    job = dict(kind="round", cfg=pcfg, params=params, data=arrays, users=users, lr=LR,
               epoch_perms=perms)
    return job, ({k: np.asarray(v) for k, v in r_new.items()},
                 {k: np.asarray(v) for k, v in r_ms.items()})


def _int8_case():
    """int8 at ``(1, 2)``: one participant (the clients row), the
    reference's noise of clients index 0 in the port's flat layout."""
    rcfg, pcfg = dict(_cfg(RC), wire_codec="int8"), dict(_cfg(PC), wire_codec="int8")
    arrays = _data()
    params, r_new, r_ms, r_resid = _reference(rcfg, arrays, USERS, 1)
    rspec = RFlatSpec({k: v.shape for k, v in params.items()})
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params))
    spec = RoundEngine(model, pcfg, torch.device("cpu")).spec
    key = jax.random.key(KEY)
    ref_noise = np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0), (rspec.total,),
        jnp.float32))
    leaves = {k: np.asarray(v) for k, v in rspec.unflatten(jnp.asarray(ref_noise)).items()}
    noise = spec.flatten(params_from_jax(leaves)).numpy()[None]
    perms, _ = reference_draws(key, USERS, rcfg["num_epochs"]["local"], arrays[0].shape[1])
    job = dict(kind="round", cfg=pcfg, params=params, data=arrays, users=USERS, lr=LR,
               epoch_perms=perms, codec_noise=noise)
    return job, (r_new, r_ms, r_resid, params, arrays, pcfg)


def _lm_case(rp):
    """The masked LM round at ``(2, 2)``, dropout 0, against the
    reference's on ``make_mesh(2, 2)`` with its whole-window corruption."""
    rcfg, pcfg = lm_cfg(RC, **NO_DROP), lm_cfg(PC, **NO_DROP)
    rows, lm = _round_data()
    key = jax.random.key(7)
    eng = RRoundEngine(r_make_model(rcfg), rcfg, make_mesh(2, 2))
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in rp.items()}, key, LM_LR, USERS,
                                  (jnp.asarray(rows), jnp.asarray(lm)))
    slot_keys = client_stream_keys(key, jnp.asarray(USERS))
    steps = pcfg["num_epochs"]["local"] * -(-rows.shape[2] // BPTT)
    draws = {(int(u), t): draws_of(jax.random.fold_in(slot_keys[i], 5000 + t), rows.shape[1],
                                   BPTT, train=False)
             for i, u in enumerate(USERS) for t in range(steps)}
    job = dict(kind="round", cfg=pcfg, params=rp, data=(rows, lm), users=USERS, lr=LM_LR,
               lm_draws=draws)
    return job, ({k: np.asarray(v) for k, v in r_new.items()},
                 {k: np.asarray(v) for k, v in r_ms.items()}, steps)


def _seqlm_case(rp):
    """``SeqParallelLM`` of the small LM (dropout 0) at ``(1, 2)``: the
    reference's forward and one train step on ``make_mesh(1, 2)``, each
    data rank's corruption ``bernoulli(fold_in(fold_in(key, d), 0))`` of its
    positions, handed to the port as the whole window's."""
    rcfg, pcfg = lm_cfg(RC, **NO_DROP), lm_cfg(PC, **NO_DROP)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 50, size=(4, BPTT)).astype(np.int64)
    rlm = RSeqParallelLM(rcfg, make_mesh(1, 2))
    keys = {"fwd": jax.random.key(11), "step": jax.random.key(12)}
    draws = {n: np.concatenate([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(jax.random.fold_in(k, d), 0), MR, (4, BPTT // 2)))
        for d in range(2)], 1) for n, k in keys.items()}
    params = {k: jnp.asarray(v) for k, v in rp.items()}
    loss = float(rlm.forward(params, jnp.asarray(labels), keys["fwd"]))
    new, _, step_loss = rlm.train_step(params, rlm.init_opt(params), jnp.asarray(labels),
                                       keys["step"], LM_LR)
    job = dict(kind="seqlm", cfg=pcfg, params=rp, labels=labels, draws=draws, lr=LM_LR)
    return job, (loss, float(step_loss), {k: np.asarray(v) for k, v in new.items()})


def _superstep_case():
    pcfg = _cfg(PC)
    model = make_model(pcfg)
    model.init_(torch.Generator().manual_seed(0))
    from heterofl_tpu_torch.convert import params_to_jax

    params = params_to_jax({k: v.detach() for k, v in model.named_parameters()},
                           model.jax_perms())
    users = np.array([[0, 1, 2, 3], [3, 1, 0, 2]])
    rates = np.asarray(pcfg["model_rate"], np.float32)[users]
    return dict(kind="superstep", cfg=pcfg, params=params, data=_data(), users=users,
                rates=rates, lr=LR, k=2)


def _entry_argv(out_dir, rounds, resume=0):
    return ["--device", "cpu", "--control_name", "1_8_0.5_iid_fix_a1-b1_bn_1_1",
            "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
            "--synthetic_sizes", '{"train": 160, "test": 40}', "--wire_codec", "int8",
            "--output_dir", out_dir, "--resume_mode", str(resume), "--eval_interval", "2",
            "--sampler", "prp", "--superstep_rounds", "2",
            "--mesh", json.dumps({"clients": 2, "data": 2}),
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1},
                                      "conv": {"hidden_size": [4, 8]}})]


@pytest.fixture(scope="module")
def spawned(ref_model, tmp_path_factory):  # noqa: F811
    """The reference side of every case and ONE spawn of two ranks at
    ``(1, 2)`` and ONE of four at ``(2, 2)`` running the cases' jobs in
    turn; the one-rank evaluations in this process."""
    out = tmp_path_factory.mktemp("data_mesh")
    _, _, rp = ref_model
    eval_job, eval_lm_job = _eval_cases(ref_model)
    two_cases = {"conv": _conv_case(1), "int8": _int8_case(), "seqlm": _seqlm_case(rp),
                 "superstep": (_superstep_case(), None), "eval": (eval_job, None),
                 "eval_lm": (eval_lm_job, None)}
    full, part = str(out / "full"), str(out / "part")
    entry = dict(kind="entry", entry="train_classifier_fed")
    four_cases = {"conv": _conv_case(2), "sharded": _sharded_case(), "lm": _lm_case(rp),
                  "eval": (eval_job, None),
                  "full": (dict(entry, argv=_entry_argv(full, 4)), None),
                  "part": (dict(entry, argv=_entry_argv(part, 2)), None),
                  "resumed": (dict(entry, argv=_entry_argv(part, 4, resume=1)), None)}
    res = {}
    for n, cases in ((2, two_cases), (4, four_cases)):
        ranks = run_ranks(dict(kind="seq", deterministic=True, n_data=2,
                               jobs=[c[0] for c in cases.values()]), n, str(out / f"w{n}"))
        res[n] = {name: ([rk["results"][i] for rk in ranks], cases[name][1])
                  for i, name in enumerate(cases)}
    one = M.single_mesh(torch.device("cpu"))
    res["one"] = {"eval": _eval_job(dict(eval_job, out_dir=str(out)), one, torch),
                  "eval_lm": _eval_job(dict(eval_lm_job, out_dir=str(out)), one, torch)}
    res["entry"] = {"full": full, "part": part}
    return res


def _ranks_equal(case, outs):
    for r, out in enumerate(outs[1:], start=1):
        assert np.array_equal(out["flat"], outs[0]["flat"]), f"{case}: rank {r} params"
        for k in ("loss_sum", "score_sum", "n"):
            assert np.array_equal(out["round"][k], outs[0]["round"][k]), f"{case}: rank {r} {k}"


# --- rounds against the reference's mesh ----------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("what", ["params", "counts", "sums"])
def test_conv_round_on_the_data_axis_matches_reference_mesh(spawned, world, what):
    """The masked conv round (levels a, b, c, e; a user with padding
    batches) at ``(1, 2)`` and ``(2, 2)``: each data rank takes its 5 of
    every batch of 10, BN synchronised over the data group, against the
    reference's round on ``make_mesh(1, 2)`` / ``make_mesh(2, 2)`` with its
    epoch permutations: params atol 5e-5, ``n`` and rates exactly, loss and
    correct sums rtol/atol 1e-4."""
    outs, (r_new, r_ms, _, _) = spawned[world]["conv"]
    case = f"conv round at {world // 2} x 2"
    if what == "params":
        for out in outs:
            assert_close(f"{case}: params", _flat(out["params"]), _flat(r_new), rtol=0, atol=5e-5)
    elif what == "counts":
        for out in outs:
            np.testing.assert_array_equal(out["round"]["n"], r_ms["n"])
            np.testing.assert_array_equal(out["round"]["rate"], r_ms["rate"])
    else:
        for k in ("loss_sum", "score_sum"):
            assert_close(f"{case}: {k}", outs[0]["round"][k], r_ms[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_data_ranks_are_bit_for_bit_equal_and_count_by_axis(spawned, world):
    """Every rank ends the round with rank 0's params and metric rows bit for
    bit; the clients group makes one all-reduce and one gather a round; the
    data group one all-reduce a local step and two a BN site (the audit's
    ``data_step_budget``), no ring shift: each row trains its slots' 20
    steps (2 epochs of 10 batches) a client."""
    outs, (_, _, pcfg, _) = spawned[world]["conv"]
    _ranks_equal(f"conv at {world} ranks", outs)
    per = data_step_budget(make_model(pcfg), 2)
    steps = (4 // (world // 2)) * pcfg["num_epochs"]["local"] * 10
    for out in outs:
        assert out["collectives"]["all_reduce"] == 1 and out["collectives"]["gather"] == 1
        assert out["data_collectives"]["all_reduce"] == steps * per["all_reduce"] == steps * 5
        assert out["data_collectives"]["ring_shift"] == 0


def test_sharded_placement_on_the_data_axis_matches_reference_mesh(spawned):
    """``data_placement='sharded'`` at ``(2, 2)``: each clients row holds
    users ``[2c, 2c + 2)`` on both its data ranks and trains the cohort's
    users it holds; params within atol 5e-5 of the reference's sharded
    round on ``make_mesh(2, 2)``, the metric rows its rows in schedule
    order (the reference's by owning row), every rank equal."""
    outs, (r_new, r_ms) = spawned[4]["sharded"]
    _ranks_equal("sharded at (2, 2)", outs)
    assert_close("sharded (2, 2): params", _flat(outs[0]["params"]), _flat(r_new), rtol=0,
                 atol=5e-5)
    order = [1, 3, 0, 2]  # schedule positions of the reference's row-order rows
    for k in ("n", "loss_sum", "score_sum"):
        assert_close(f"sharded (2, 2): {k}", outs[0]["round"][k][order], r_ms[k], rtol=1e-4,
                     atol=1e-4)


@pytest.mark.parametrize("what", ["params", "counts", "sums", "ranks"])
def test_lm_round_on_the_data_axis_matches_reference_mesh(spawned, what):
    """The masked LM round at ``(2, 2)`` (each data rank 8 of the 16
    positions of every window, ring attention over the data group, the
    position count reduced with the gradient), dropout 0, the reference's
    corruption handed in, against ``make_mesh(2, 2)``: params atol 5e-5,
    ``n`` exactly, sums rtol/atol 1e-4; the ranks bit for bit equal; one
    all-reduce and ``3 L`` ring shifts a step on the data group."""
    outs, (r_new, r_ms, steps) = spawned[4]["lm"]
    if what == "params":
        for out in outs:
            assert_close("LM round 2 x 2: params", _flat(out["params"]), _flat(r_new), rtol=0,
                         atol=5e-5)
    elif what == "counts":
        np.testing.assert_array_equal(outs[0]["round"]["n"], r_ms["n"])
    elif what == "sums":
        for k in ("loss_sum", "score_sum"):
            assert_close(f"LM round 2 x 2: {k}", outs[0]["round"][k], r_ms[k], rtol=1e-4,
                         atol=1e-4)
    else:
        _ranks_equal("LM at 4 ranks", outs)
        for out in outs:  # 2 slots a row, 2 layers: 3 shifts a layer at n = 2
            assert out["data_collectives"]["all_reduce"] == 2 * steps
            assert out["data_collectives"]["ring_shift"] == 2 * steps * 2 * 3


def test_int8_round_on_the_data_axis_matches_reference_mesh(spawned):
    """int8 at ``(1, 2)``: the codec's one participant is the clients row,
    its noise the reference's of clients index 0, so both data ranks encode
    the same payload and carry the same residual; against
    ``make_mesh(1, 2)`` under the one-grid-step contract: params within
    5e-5 but at most 2% of entries one step ``s_leaf / count`` apart, the
    residual within 2 x 5e-5 but at most 2% one step ``s_leaf`` apart."""
    outs, (r_new, r_ms, r_resid, params, arrays, pcfg) = spawned[2]["int8"]
    rspec = RFlatSpec({k: v.shape for k, v in params.items()})
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params))
    peng = RoundEngine(model, pcfg, torch.device("cpu"))
    spec = peng.spec

    def to_port(ref_flat):
        leaves = {k: np.asarray(v) for k, v in rspec.unflatten(jnp.asarray(ref_flat)).items()}
        return spec.flatten(params_from_jax(leaves))

    _ranks_equal("int8 at (1, 2)", outs)
    assert np.array_equal(outs[0]["resid"], outs[1]["resid"])
    s = make_codec("int8", spec, 1).scale_flat(peng.flatten(model.params()), 1)
    data = tuple(torch.from_numpy(a) for a in arrays)
    wrs = to_width_rates(peng.fix_rates[USERS], pcfg)
    counts = torch.stack([peng.count_mask_flat(float(wr), data[3][u])
                          for u, wr in zip(USERS, wrs)]).sum(0)
    assert_grid_close("int8 (1, 2): params", torch.from_numpy(outs[0]["flat"]),
                      to_port(rspec.flatten(r_new)),
                      torch.where(counts > 0, s / counts.clamp_min(1), 0.0),
                      atol=5e-5, max_share=0.02)
    assert_grid_close("int8 (1, 2): residual", outs[0]["resid"][0], to_port(r_resid[0, 0]), s,
                      atol=5e-5 * 2, max_share=0.02)
    np.testing.assert_array_equal(outs[0]["round"]["n"], r_ms["n"])


# --- SeqParallelLM, the superstep ----------------------------------------------------------

@pytest.mark.parametrize("what", ["forward", "step_loss", "params"])
def test_seq_parallel_lm_matches_reference(spawned, what):
    """``SeqParallelLM`` at ``(1, 2)`` (ring attention, each layer under
    ``torch.utils.checkpoint``) against the JAX package's on
    ``make_mesh(1, 2)``: the forward's global mean loss and the train step's
    within rtol 1e-5; the stepped params within atol 5e-5."""
    outs, (loss, step_loss, new) = spawned[2]["seqlm"]
    for out in outs:
        if what == "forward":
            assert_close("SeqParallelLM.forward", out["loss"], loss, rtol=1e-5, atol=0)
        elif what == "step_loss":
            assert_close("SeqParallelLM.train_step loss", out["step_loss"], step_loss, rtol=1e-5,
                         atol=0)
        else:
            assert_close("SeqParallelLM.train_step params", _flat(out["params"]), _flat(new),
                         rtol=0, atol=5e-5)


@pytest.mark.parametrize("what", ["params", "rows"])
def test_superstep_equals_sequential_rounds_on_the_data_axis(spawned, what):
    """At ``(1, 2)`` the superstep of two rounds (its steps eager: a step
    holds collectives) equals the two rounds through ``train_round`` bit for
    bit, on every rank: params and each round's metric rows."""
    outs, _ = spawned[2]["superstep"]
    for out in outs:
        if what == "params":
            np.testing.assert_array_equal(out["superstep"], out["seq"])
        else:
            for a, b in zip(out["superstep_rows"], out["seq_rows"]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(outs[0]["superstep"], outs[1]["superstep"])


# --- evaluation, the entry and its checkpoint -----------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_evaluation_shards_over_the_flat_axis(spawned, world):
    """sBN, Local and Global over all ranks as one axis (``Mesh.flat``: each
    rank its block of train batches, users and test batches; one collective
    a pass over the world) against one rank: BN statistics and Global sums
    within rtol 1e-5 / atol 1e-6, Local within rtol/atol 1e-5; fused ==
    host on every rank; the LM's Global pass (at two ranks) within rtol
    1e-6."""
    one = spawned["one"]["eval"]
    outs, _ = spawned[world]["eval"]
    for out in outs:
        assert out["collectives"]["all_reduce"] == 4 and out["collectives"]["gather"] == 2
        for k in ("loss_sum", "score_sum", "n"):
            np.testing.assert_array_equal(out["fused"]["local"][k], out["local"][k])
            assert_close(f"flat Local {k} at {world}", out["local"][k], one["local"][k],
                         rtol=1e-5, atol=1e-5)
            assert_close(f"flat Global {k} at {world}", out["global"][k], one["global"][k],
                         rtol=1e-5, atol=1e-6)
        for site, (m, v) in one["bn"].items():
            assert_close(f"flat sBN {site} mean", out["bn"][site][0], m, rtol=1e-5, atol=1e-6)
            assert_close(f"flat sBN {site} var", out["bn"][site][1], v, rtol=1e-5, atol=1e-6)
    if world == 2:
        lm, one_lm = spawned[2]["eval_lm"][0], spawned["one"]["eval_lm"]
        for k in ("loss_sum", "score_sum", "n"):
            assert_close(f"flat LM Global {k}", lm[1]["global"][k], one_lm["global"][k],
                         rtol=1e-6, atol=0)


def test_entry_on_the_data_axis_resumes_bit_for_bit(spawned):
    """``train_classifier_fed`` at ``(2, 2)`` (int8, a residual row a
    clients row; supersteps of two): 4 rounds uninterrupted against 2 then a
    resumed superstep -- params, residual rows and records bit for bit on
    every rank; the data ranks of a row hold the row's residual; only world
    rank 0 writes the log; the header records ``(clients, data)`` and names
    one shard a clients row."""
    a, b = spawned[4]["full"][0], spawned[4]["resumed"][0]
    for r in range(4):
        for k in a[r]["params"]:
            np.testing.assert_array_equal(a[r]["params"][k], b[r]["params"][k], err_msg=k)
            np.testing.assert_array_equal(a[r]["params"][k], a[0]["params"][k], err_msg=k)
        np.testing.assert_array_equal(a[r]["wire_resid"], b[r]["wire_resid"])
        np.testing.assert_array_equal(a[r]["wire_resid"], a[r - r % 2]["wire_resid"])
        assert [h["loss"] for h in b[r]["history"]] == [h["loss"] for h in a[r]["history"][2:]]
    assert not np.array_equal(a[0]["wire_resid"], a[2]["wire_resid"])
    full = spawned["entry"]["full"]
    (log,) = glob.glob(os.path.join(full, "runs", "*", "log.jsonl"))
    with open(log) as f:
        assert sum('"tag": "train"' in line for line in f) == 4
    (path,) = glob.glob(os.path.join(full, "model", "*_checkpoint.pkl"))
    header = load_checkpoint(path)
    assert header["mesh_layout"] == {"mesh": [2, 2]}
    assert header[SHARD_SET_KEY]["count"] == 2 and len(header[SHARD_SET_KEY]["files"]) == 2
    assert checkpoint_path(full, os.path.basename(path)[:-len("_checkpoint.pkl")]) == path


def test_resume_refuses_another_layout():
    """A checkpoint written at ``(2, 2)`` resumes only at ``(2, 2)``; one
    written at data 1 does not resume onto a data axis."""
    cpu = torch.device("cpu")
    at = lambda c, d: M.Mesh(rank=0, size=c, device=cpu, data_size=d)  # noqa: E731
    blob = {"epoch": 2, "mesh_layout": {"mesh": [2, 2]}}
    check_mesh_layout(blob, {"mesh": [2, 2]}, at(2, 2))
    for c, d in ((4, 1), (1, 4), (1, 2)):
        with pytest.raises(ValueError, match="resume at the checkpoint's layout"):
            check_mesh_layout(blob, None if d == 1 else {"mesh": [c, d]}, at(c, d))
    with pytest.raises(ValueError, match="resume at the checkpoint's layout"):
        check_mesh_layout({"epoch": 2}, {"mesh": [1, 2]}, at(1, 2))
    check_mesh_layout({"epoch": 2}, None, at(2, 1))
