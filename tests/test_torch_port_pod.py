"""The clients mesh axis of the PyTorch/CUDA port at two ranks: gloo ranks on
the CPU (``torch_port_ranks.run_ranks``, one process a rank with its own
free port and a timeout of its own), every case's job in turn in ONE spawn
of two ranks and its one-rank runs in one spawn of one (:func:`spawned`),
under deterministic algorithms.

* one masked round -- conv dense, conv int8, the LM -- against the JAX
  package's ``RoundEngine`` on ``make_mesh(2, 1)``, the reference's draws
  handed in as the one-device round tests hand them in (each rank its own
  int8 rounding noise, the reference's per-device codec key): params to
  atol 5e-5, metric sums to rtol/atol 1e-4, ``n`` and the rates exactly;
  int8 under the one-grid-step contract;
* the ranks' params and metrics bit for bit equal, and the two-rank round
  within ``RANKS_ATOL`` of the one-rank round (the sums associate by rank);
* ``data_placement='sharded'``: each rank holds half the users and the
  round is the replicated round's;
* a sharded evaluation (sBN, Local, Global; the LM's Global) against the
  one-rank one, fused == host on each rank;
* the entry at two ranks: resumed == uninterrupted bit for bit (the int8
  residual in a sharded checkpoint), and only rank 0 writing the log."""

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
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.parallel import shard_client_data as r_shard_client_data
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress import make_codec
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.fed.core import to_width_rates
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import RoundEngine
from heterofl_tpu_torch.parallel.pod import RANKS_ATOL
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture

from test_torch_port_lm import BPTT, _round_data, draws_of, ref_model  # noqa: F401
from test_torch_port_lm import LR as LM_LR
from test_torch_port_lm import _cfg as lm_cfg
from test_torch_port_round import LR, _cfg, _data, reference_draws
from torch_port_ranks import run_ranks

few_threads = thread_limit_fixture()

USERS = np.array([0, 1, 2, 3])
KEY = 3


def _flat(params):
    return np.concatenate([np.asarray(params[k]).ravel() for k in sorted(params)])


def _reference(rcfg, arrays, users, n_dev=2, sharded=False, key=KEY, lr=LR, params=None):
    """One reference round on ``make_mesh(n_dev, 1)`` from its key-0 init
    (or ``params``) -> (initial params, new params, metrics, residual)."""
    rmodel = r_make_model(rcfg)
    if params is None:
        params = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    mesh = make_mesh(n_dev, 1)
    eng = RRoundEngine(rmodel, dict(rcfg, data_placement="sharded") if sharded else rcfg, mesh)
    data = r_shard_client_data(mesh, arrays) if sharded else tuple(jnp.asarray(a)
                                                                   for a in arrays)
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in params.items()},
                                  jax.random.key(key), lr, np.asarray(users), data)
    return (params, {k: np.asarray(v) for k, v in r_new.items()},
            {k: np.asarray(v) for k, v in r_ms.items()}, eng.wire_resid_host())


def _round_job(pcfg, params, arrays, users, **extra):
    return dict(kind="round", cfg=pcfg, params=params, data=arrays, users=users, lr=LR,
                **extra)


def _assert_ranks_equal(case, outs):
    """Every rank's params and metric rows bit for bit rank 0's."""
    for r, out in enumerate(outs[1:], start=1):
        assert np.array_equal(out["flat"], outs[0]["flat"]), f"{case}: rank {r} params"
        for k in ("loss_sum", "score_sum", "n"):
            assert np.array_equal(out["round"][k], outs[0]["round"][k]), \
                f"{case}: rank {r} {k}"


def _assert_matches_reference(case, out, r_new, r_ms):
    assert_close(f"{case}: new global params", _flat(out["params"]), _flat(r_new),
                 rtol=0, atol=5e-5)
    ms = out["round"]
    assert_close(f"{case}: n", ms["n"], r_ms["n"][:len(ms["n"])], rtol=0, atol=0)
    for k in ("loss_sum", "score_sum"):
        assert_close(f"{case}: {k}", ms[k], r_ms[k][:len(ms[k])], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ms["rate"], r_ms["rate"][:len(ms["rate"])])


def _conv_case():
    rcfg, pcfg = _cfg(RC), _cfg(PC)
    arrays = _data()
    params, r_new, r_ms, _ = _reference(rcfg, arrays, USERS)
    perms, _ = reference_draws(jax.random.key(KEY), USERS, rcfg["num_epochs"]["local"],
                               arrays[0].shape[1])
    return _round_job(pcfg, params, arrays, USERS, epoch_perms=perms), (r_new, r_ms)


def test_conv_round_at_two_ranks_matches_reference_mesh(spawned):
    """The conv round (levels a, b, c, e; a user with padding batches) at two
    gloo ranks, each training its two slots, against the reference's round on
    ``make_mesh(2, 1)`` with its epoch permutations; the ranks equal bit for
    bit; the two-rank round within ``RANKS_ATOL`` of the one-rank round."""
    outs, (r_new, r_ms) = spawned["conv"]
    _assert_ranks_equal("conv round, 2 ranks", outs)
    _assert_matches_reference("conv round, 2 ranks vs make_mesh(2, 1)", outs[0], r_new, r_ms)
    assert outs[0]["collectives"]["all_reduce"] == 1 and outs[0]["collectives"]["gather"] == 1
    one = spawned["one"]["conv"]
    assert_close("conv round: 2 ranks vs 1 rank, params", outs[0]["flat"], one["flat"],
                 rtol=0, atol=RANKS_ATOL)
    for k in ("loss_sum", "score_sum", "n"):  # a slot trains on one rank, as on one
        np.testing.assert_array_equal(outs[0]["round"][k], one["round"][k])


def _sharded_case():
    rcfg, pcfg = _cfg(RC), dict(_cfg(PC), data_placement="sharded")
    arrays = _data()
    users = np.array([3, 0, 2, 1])  # owners 1, 0, 1, 0
    params, r_new, r_ms, _ = _reference(rcfg, arrays, users, sharded=True)
    perms, _ = reference_draws(jax.random.key(KEY), users, rcfg["num_epochs"]["local"],
                               arrays[0].shape[1])
    return _round_job(pcfg, params, arrays, users, epoch_perms=perms), (r_new, r_ms)


def test_conv_round_sharded_placement_at_two_ranks(spawned):
    """``data_placement='sharded'``: each rank holds users ``[2r, 2r + 2)``
    and trains the cohort's users it holds (the reference's owner packing);
    the params are the reference's sharded round's on ``make_mesh(2, 1)``,
    the metric rows the replicated round's, in schedule order."""
    outs, (r_new, r_ms) = spawned["sharded"]
    _assert_ranks_equal("sharded conv round", outs)
    assert_close("sharded conv round vs the reference's sharded round: params",
                 _flat(outs[0]["params"]), _flat(r_new), rtol=0, atol=5e-5)
    # the reference's rows are by owning device: [users 0, 1 | users 3, 2]
    ms = outs[0]["round"]
    order = [1, 3, 0, 2]  # schedule positions of the reference's device-order rows
    for k in ("n", "loss_sum", "score_sum"):
        assert_close(f"sharded conv round: {k}", ms[k][order], r_ms[k], rtol=1e-4, atol=1e-4)


def _int8_case():
    rcfg, pcfg = dict(_cfg(RC), wire_codec="int8"), dict(_cfg(PC), wire_codec="int8")
    arrays = _data()
    params, r_new, r_ms, r_resid = _reference(rcfg, arrays, USERS)
    rspec = RFlatSpec({k: v.shape for k, v in params.items()})
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params))
    spec = RoundEngine(model, pcfg, torch.device("cpu")).spec

    def to_port(ref_flat):
        leaves = {k: np.asarray(v) for k, v in rspec.unflatten(jnp.asarray(ref_flat)).items()}
        return spec.flatten(params_from_jax(leaves))

    key = jax.random.key(KEY)
    noise = np.stack([to_port(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), d), (rspec.total,),
        jnp.float32))).numpy() for d in range(2)])
    perms, _ = reference_draws(key, USERS, rcfg["num_epochs"]["local"], arrays[0].shape[1])
    return (_round_job(pcfg, params, arrays, USERS, epoch_perms=perms, codec_noise=noise),
            (r_new, r_ms, r_resid, params, arrays))


def test_int8_round_at_two_ranks_matches_reference_mesh(spawned):
    """The int8 codec at two ranks: each rank encodes its partial sums with
    its own residual row and the reference's noise of its device
    (``uniform(fold_in(fold_in(key, 9173), d))``), the packed payload is
    all-reduced once and both decode it.  Contract (the one-device int8
    round's): params within 5e-5 but at most 2% of entries one grid step
    ``s_leaf / count`` apart; each rank's residual within 2 x 5e-5 but at
    most 2% of entries one step ``s_leaf`` apart; ``n`` exactly; the ranks
    equal bit for bit."""
    outs, (r_new, r_ms, r_resid, params, arrays) = spawned["int8"]
    pcfg = dict(_cfg(PC), wire_codec="int8")
    rspec = RFlatSpec({k: v.shape for k, v in params.items()})
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params))
    peng = RoundEngine(model, pcfg, torch.device("cpu"))
    spec = peng.spec

    def to_port(ref_flat):
        leaves = {k: np.asarray(v) for k, v in rspec.unflatten(jnp.asarray(ref_flat)).items()}
        return spec.flatten(params_from_jax(leaves))

    _assert_ranks_equal("int8 round, 2 ranks", outs)
    P = peng.flatten(model.params())
    s = make_codec("int8", spec, 2).scale_flat(P, 2)
    data = tuple(torch.from_numpy(a) for a in arrays)
    wrs = to_width_rates(peng.fix_rates[USERS], pcfg)
    counts = torch.stack([peng.count_mask_flat(float(wr), data[3][u])
                          for u, wr in zip(USERS, wrs)]).sum(0)
    case = "int8 round, 2 ranks vs make_mesh(2, 1)"
    assert_grid_close(f"{case}: new params", torch.from_numpy(outs[0]["flat"]),
                      to_port(rspec.flatten(r_new)),
                      torch.where(counts > 0, s / counts.clamp_min(1), 0.0),
                      atol=5e-5, max_share=0.02)
    assert r_resid.shape == (2, 1, rspec.total)
    for d, out in enumerate(outs):
        assert out["resid"].shape == (1, spec.total)
        assert_grid_close(f"{case}: rank {d} residual", out["resid"][0],
                          to_port(r_resid[d, 0]), s, atol=5e-5 * 2, max_share=0.02)
    np.testing.assert_array_equal(outs[0]["round"]["n"], r_ms["n"])
    assert not np.array_equal(outs[0]["resid"], outs[1]["resid"])


def _lm_case(ref_model):  # noqa: F811
    _, _, rp = ref_model
    rcfg, pcfg = lm_cfg(RC), lm_cfg(PC)
    rows, lm = _round_data()
    key = jax.random.key(7)
    rmodel = r_make_model(rcfg)
    eng = RRoundEngine(rmodel, rcfg, make_mesh(2, 1))
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in rp.items()}, key, LM_LR, USERS,
                                  (jnp.asarray(rows), jnp.asarray(lm)))
    slot_keys = client_stream_keys(key, jnp.asarray(USERS))
    steps = pcfg["num_epochs"]["local"] * -(-rows.shape[2] // BPTT)
    draws = {(int(u), t): draws_of(jax.random.fold_in(slot_keys[i], 5000 + t), rows.shape[1],
                                   BPTT)
             for i, u in enumerate(USERS) for t in range(steps)}
    job = dict(kind="round", cfg=pcfg, params=rp, data=(rows, lm), users=USERS, lr=LM_LR,
               lm_draws=draws)
    return job, ({k: np.asarray(v) for k, v in r_new.items()},
                 {k: np.asarray(v) for k, v in r_ms.items()})


def test_lm_round_at_two_ranks_matches_reference_mesh(spawned):
    """The masked LM round (levels a, b, c, e) at two ranks against the
    reference's on ``make_mesh(2, 1)``, each client's corruption and dropout
    draws the reference's: params atol 5e-5, sums 1e-4, ``n`` exactly; the
    ranks equal bit for bit."""
    outs, (r_new, r_ms) = spawned["lm"]
    _assert_ranks_equal("LM round, 2 ranks", outs)
    _assert_matches_reference("LM round, 2 ranks vs make_mesh(2, 1)", outs[0], r_new, r_ms)


def _eval_operands(cfg, users=3):
    """Odd counts at two ranks: 11 sBN batches, 3 users, 3 Global batches
    (the fused pass pads each to a multiple of the ranks)."""
    from heterofl_tpu_torch.data import (fetch_dataset, label_split_masks, split_dataset)
    from heterofl_tpu_torch.entry.common import stage_eval_operands

    ds = fetch_dataset("MNIST", synthetic=True, seed=0,
                       synthetic_sizes={"train": 110, "test": 110})
    split, lsplit = split_dataset(ds, users, "iid", np.random.default_rng(0), classes_size=10)
    lm = label_split_masks(lsplit, users, 10)
    return stage_eval_operands(dict(cfg, num_users=users), ds["train"], ds["test"],
                               split["test"], lm)


def _eval_cases(ref_model):  # noqa: F811
    """The vision evaluation's job and the LM Global pass's."""
    from heterofl_tpu_torch.convert import params_to_jax
    from heterofl_tpu_torch.data import bptt_windows, stack_windows
    from heterofl_tpu_torch.data.datasets import synthetic_lm
    from heterofl_tpu_torch.data.pipeline import batchify

    pcfg = _cfg(PC)
    model = make_model(pcfg)
    params = {k: v.detach() for k, v in model.init_(
        torch.Generator().manual_seed(0)).named_parameters()}
    sbn, local, glob = _eval_operands(pcfg)
    job = dict(kind="eval", cfg=pcfg, params=params_to_jax(params), sbn=sbn, local=local,
               epoch=2)
    job["global"] = glob
    _, _, rp = ref_model
    tok = synthetic_lm("WikiText2", "test", 4 * 70, 50, 5).token
    wins = stack_windows(bptt_windows(batchify(tok, 4), BPTT), BPTT)
    lm_job = dict(kind="eval", cfg=lm_cfg(PC), params=rp, sbn=None, epoch=3)
    lm_job["global"] = wins
    return job, lm_job


def test_sharded_evaluation_matches_one_rank(spawned):
    """sBN, Local and Global at two ranks (each its block of train batches,
    users and test batches; one collective a pass) against one rank: the
    BN statistics and Global sums within rtol 1e-5 / atol 1e-6 (two partial
    sums), the Local rows within rtol 1e-5 / atol 1e-5 (each user's rows
    computed whole on one rank, on those statistics); the LM's Global sums
    (each rank's windows corrupted as on one rank) within rtol 1e-6; fused
    == host bit for bit on every rank."""
    two, one = spawned["eval"][0], spawned["one"]["eval"]
    assert two[0]["collectives"]["all_reduce"] == 4 and two[0]["collectives"]["gather"] == 2
    for case, out in (("one rank", one), ("rank 0", two[0]), ("rank 1", two[1])):
        f = out["fused"]
        for k in ("loss_sum", "score_sum", "n"):
            np.testing.assert_array_equal(f["local"][k], out["local"][k], err_msg=case)
        assert f["global"] == out["global"], case
    for site, (m, v) in one["bn"].items():
        assert_close(f"sharded sBN {site}: mean", two[0]["bn"][site][0], m, rtol=1e-5, atol=1e-6)
        assert_close(f"sharded sBN {site}: var", two[0]["bn"][site][1], v, rtol=1e-5, atol=1e-6)
    for k in ("loss_sum", "score_sum", "n"):
        assert_close(f"sharded Local {k}", two[0]["local"][k], one["local"][k], rtol=1e-5,
                     atol=1e-5)
        assert_close(f"sharded Global {k}", two[0]["global"][k], one["global"][k], rtol=1e-5,
                     atol=1e-6)
        np.testing.assert_array_equal(two[0]["local"][k], two[1]["local"][k])
    # the LM's Global pass: the corruption of a rank's windows is one rank's
    two, one = spawned["eval_lm"][0], spawned["one"]["eval_lm"]
    for k in ("loss_sum", "score_sum", "n"):
        assert_close(f"sharded LM Global {k}", two[1]["global"][k], one["global"][k],
                     rtol=1e-6, atol=0)
        assert two[0]["fused"]["global"][k] == two[0]["global"][k]


def _entry_argv(out_dir, rounds, resume=0):
    return ["--device", "cpu", "--control_name", "1_8_0.5_iid_fix_a1-b1_bn_1_1",
            "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
            "--synthetic_sizes", '{"train": 160, "test": 40}', "--wire_codec", "int8",
            "--output_dir", out_dir, "--resume_mode", str(resume), "--eval_interval", "2",
            "--sampler", "prp", "--superstep_rounds", "2",
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1},
                                      "conv": {"hidden_size": [4, 8]}})]


@pytest.fixture(scope="module")
def spawned(ref_model, tmp_path_factory):  # noqa: F811
    """Every case's reference side and its runs: ONE spawn of two ranks
    running each case's job, then the entry uninterrupted, cut and resumed;
    ONE spawn of one rank running the one-rank jobs -> ``{case: (the two
    ranks' results, the reference side)}``, ``"one"``: the one-rank
    results, ``"entry"``: the entry's dirs and results."""
    out = tmp_path_factory.mktemp("pod")
    cases = {"conv": _conv_case(), "sharded": _sharded_case(), "int8": _int8_case(),
             "lm": _lm_case(ref_model)}
    job, lm_job = _eval_cases(ref_model)
    cases["eval"], cases["eval_lm"] = (job, None), (lm_job, None)
    full, part = str(out / "full"), str(out / "part")
    entry = dict(kind="entry", entry="train_classifier_fed")
    entries = {"full": dict(entry, argv=_entry_argv(full, 4)),
               "part": dict(entry, argv=_entry_argv(part, 2)),
               "resumed": dict(entry, argv=_entry_argv(part, 4, resume=1))}
    names = list(cases) + list(entries)
    two = run_ranks(dict(kind="seq", deterministic=True,
                         jobs=[cases[n][0] for n in cases] + list(entries.values())), 2,
                    str(out / "two"))
    ones = ["conv", "eval", "eval_lm"]
    (one,) = run_ranks(dict(kind="seq", deterministic=True, jobs=[cases[n][0] for n in ones]),
                       1, str(out / "one"))
    res = {n: ([rk["results"][i] for rk in two], cases[n][1] if n in cases else None)
           for i, n in enumerate(names)}
    res["one"] = dict(zip(ones, one["results"]))
    res["entry"] = {"full": full, "dir": str(out / "two")}
    return res


def test_entry_at_two_ranks_resumes_bit_for_bit(spawned):
    """``train_classifier_fed`` at two ranks (int8, a residual row a rank;
    supersteps of two rounds): 4 rounds uninterrupted against 2 rounds then
    a resumed superstep (each rank restoring its row from the sharded
    checkpoint) -- params, residual rows and round records bit for bit;
    every rank ends with the same params; only rank 0 writes the log (one
    record a round) and prints it; each rank writes its shard file."""
    a, b = spawned["full"][0], spawned["resumed"][0]
    full = spawned["entry"]["full"]
    for r in range(2):
        for k in a[r]["params"]:
            np.testing.assert_array_equal(a[r]["params"][k], b[r]["params"][k], err_msg=k)
            np.testing.assert_array_equal(a[r]["params"][k], a[0]["params"][k], err_msg=k)
        np.testing.assert_array_equal(a[r]["wire_resid"], b[r]["wire_resid"])
        assert [h["epoch"] for h in b[r]["history"]] == [3, 4]
        assert [h["loss"] for h in b[r]["history"]] == [h["loss"] for h in a[r]["history"][2:]]
    assert not np.array_equal(a[0]["wire_resid"], a[1]["wire_resid"])
    (log,) = glob.glob(os.path.join(full, "runs", "*", "log.jsonl"))
    with open(log) as f:
        train = [json.loads(line) for line in f if '"tag": "train"' in line]
    assert len(train) == 4
    outs = [open(os.path.join(spawned["entry"]["dir"], f"rank{r}.out")).read() for r in range(2)]
    assert "Train Epoch" in outs[0] and "Train Epoch" not in outs[1]
    model = os.path.join(full, "model")
    assert sorted(os.path.basename(p)[-15:] for p in glob.glob(os.path.join(
        model, "*_checkpoint.pkl.shard*-of-002"))) == ["shard000-of-002", "shard001-of-002"]
