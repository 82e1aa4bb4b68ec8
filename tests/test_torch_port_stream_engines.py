"""The streamed superstep of the PyTorch/CUDA port (``client_store='stream'``:
each engine's ``stage_cohort`` and ``train_superstep(cohort=...)``, and the
experiment loop's prefetched cohorts) against the port's eager store and
against the JAX reference's streamed path, on the CPU.

Contracts:

* bit for bit, a streamed run equals the same run with the eager store --
  cohorts, every logged metric, params (and the int8 residual): masked and
  grouped, vision and LM, ``superstep_rounds`` 1 and 2, prefetch depth 1
  and 2; a grouped K=1 run with the int8 codec or buffered aggregation
  (which the eager store refuses) runs;
* bit for bit, a streamed run resumed from a checkpoint taken while later
  cohorts were already prefetched (drawn from the ``perm`` stream) equals
  the uninterrupted run;
* bit for bit, cohorts staged ahead of the superstep in flight (depth 1
  and 2) train what cohorts staged one at a time train;
* against the reference's ``RoundEngine.stage_cohort`` /
  ``train_superstep(cohort=...)`` with its draws injected: the masked
  engine's contract of tests/test_torch_port_masked_superstep.py (dense
  params after 2 rounds within 5e-5, per-round sums at rtol/atol 1e-4,
  ``n`` exactly); the grouped engine's one-round int8 superstep under the
  grid contract of tests/test_torch_port_grouped_superstep.py (params
  within 5e-5 but at most 2% of entries one grid step apart, the residual
  within 4 x 5e-5 but at most 2% one step apart; sums at 1e-4, ``n`` and
  rates exactly).
"""

import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.parallel.staging import ClientStore as RClientStore
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.data import label_split_masks, stack_client_shards
from heterofl_tpu_torch.entry import (test_classifier_fed, train_classifier_fed,
                                      train_transformer_fed)
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.parallel.staging import ClientStore
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint_path
from heterofl_tpu_torch.utils.checkpoint import generation_path
from test_torch_port_round import reference_draws

# an LM round on the CPU is repeatable run to run only under the
# deterministic algorithms (tests/test_torch_port_superstep.py)
few_threads = thread_limit_fixture(deterministic=True)

VISION = "1_8_0.5_iid_fix_a1-b1-c1-e1_bn_1_1"
LM = "1_4_0.5_iid_fix_a1-e1_bn_1_1"
LM_OVERRIDE = {"bptt": 16, "transformer": {"embedding_size": 128, "num_heads": 2,
                                           "hidden_size": 64, "num_layers": 1, "dropout": 0.2}}


def _argv(out, rounds, *extra, kind="vision"):
    if kind == "lm":
        return ["--device", "cpu", "--output_dir", str(out), "--control_name", LM,
                "--synthetic", "1", "--synthetic_sizes", '{"train": 3200, "test": 320}',
                "--eval_interval", "2", "--override",
                json.dumps({"num_epochs": {"global": rounds, "local": 1}, **LM_OVERRIDE}),
                *extra]
    return ["--device", "cpu", "--output_dir", str(out), "--control_name", VISION,
            "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
            "--synthetic_sizes", '{"train": 160, "test": 80}', "--eval_interval", "2",
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1},
                                      "conv": {"hidden_size": [4, 8]}}), *extra]


def _main(kind):
    return train_transformer_fed.main if kind == "lm" else train_classifier_fed.main


def _bits(what, a, b):
    assert_close(what, a, b, rtol=0, atol=0)


def _same_runs(what, a, b, codec="dense"):
    """Cohorts, every logged metric and record, params (and residual) equal."""
    keys = ("epoch", "users", "loss", "n", "accuracy", "perplexity", "rates",
            "Global-Accuracy", "Local-Accuracy", "Global-Perplexity")
    assert [[r.get(k) for k in keys] for r in a["history"]] == \
        [[r.get(k) for k in keys] for r in b["history"]], what
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    assert hist(a) == hist(b), what
    for k, v in b["params"].items():
        assert torch.equal(a["params"][k], v), f"{what}: {k}"
    if codec != "dense":
        assert np.array_equal(a["wire_resid"], b["wire_resid"]), f"{what}: residual"
    print(f"parity {what}: max_abs_err 0 (bit for bit, {len(a['history'])} rounds)")


STREAM_CASES = {
    "masked vision K1 depth1": ("vision", "masked", 1, 1, "dense"),
    "masked vision K2 depth2 int8": ("vision", "masked", 2, 2, "int8"),
    "grouped vision K1 depth2": ("vision", "grouped", 1, 2, "dense"),
    "grouped vision K2 depth1 int8": ("vision", "grouped", 2, 1, "int8"),
    "masked LM K2 depth1": ("lm", "masked", 2, 1, "dense"),
    "grouped LM K1 depth2": ("lm", "grouped", 1, 2, "dense"),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_entry_stream_equals_eager(tmp_path, case):
    """Three rounds (evaluations at rounds 2 and 3) with the stream store
    equal the same run with the eager store, bit for bit."""
    kind, strategy, K, depth, codec = STREAM_CASES[case]
    extra = ("--strategy", strategy, "--superstep_rounds", str(K), "--wire_codec", codec)
    (eager,) = _main(kind)(_argv(tmp_path / "eager", 3, *extra, kind=kind))
    (stream,) = _main(kind)(_argv(tmp_path / "stream", 3, *extra, "--client_store", "stream",
                                  "--stream_prefetch_depth", str(depth), kind=kind))
    _same_runs(f"stream vs eager store, {case}", stream, eager, codec)
    assert all(math.isfinite(r["loss"]) for r in stream["history"])


@pytest.mark.parametrize("strategy,extra", [
    ("grouped", ("--wire_codec", "int8")),
    ("grouped", ("--schedule", '{"aggregation": "buffered"}')),
])
def test_entry_stream_grouped_k1_takes_what_the_eager_store_refuses(tmp_path, strategy, extra):
    """A grouped run at ``superstep_rounds`` 1 with a lossy codec or
    buffered aggregation: the eager store refuses it with the reference's
    message, the stream store runs it as one-round supersteps (the
    reference's exceptions, heterofl_tpu/entry/common.py:326-337 and
    heterofl_tpu/sched/__init__.py:280-287): finite losses and a non-zero
    carry."""
    argv = _argv(tmp_path / "eager", 3, "--strategy", strategy, *extra)
    with pytest.raises(ValueError, match="client_store="):
        train_classifier_fed.main(argv)
    (run,) = train_classifier_fed.main(_argv(tmp_path / "stream", 3, "--strategy", strategy,
                                             "--client_store", "stream", *extra))
    assert [r["epoch"] for r in run["history"]] == [1, 2, 3]
    assert all(math.isfinite(r["loss"]) for r in run["history"])
    carry = run["wire_resid"] if "--wire_codec" in extra else run["sched_buf"]
    assert carry is not None and np.any(carry != 0)


@pytest.mark.parametrize("strategy,K,depth", [("masked", 1, 1), ("masked", 2, 2),
                                              ("grouped", 2, 1)])
def test_entry_stream_resume_equals_uninterrupted(tmp_path, strategy, K, depth):
    """Five rounds in one streamed run, and the same run resumed from its
    checkpoint two generations back (round 3 at K=1, round 2 at K=2),
    written while the next cohorts were already prefetched from the
    ``perm`` stream: the resumed run draws the uninterrupted run's cohorts
    and ends equal to it bit for bit."""
    extra = ("--strategy", strategy, "--superstep_rounds", str(K), "--client_store", "stream",
             "--stream_prefetch_depth", str(depth))
    (full,) = train_classifier_fed.main(_argv(tmp_path / "full", 5, *extra))
    tag = f"0_MNIST_label_conv_{VISION}"
    cut = tmp_path / "cut"
    src = generation_path(checkpoint_path(str(tmp_path / "full"), tag), 2)
    dst = checkpoint_path(str(cut), tag)
    shutil.copytree(tmp_path / "full" / "model", cut / "model")
    shutil.copyfile(src, dst)
    (res,) = train_classifier_fed.main(_argv(cut, 5, *extra, "--resume_mode", "1"))
    start = 4 if K == 1 else 3
    assert [r["epoch"] for r in res["history"]] == list(range(start, 6))
    assert [r["users"] for r in res["history"]] == \
        [r["users"] for r in full["history"][start - 1:]]
    for k, v in full["params"].items():
        _bits(f"resumed stream ({strategy}, K={K}, depth {depth}): {k}", res["params"][k], v)


def test_test_entry_reproduces_a_streamed_run(tmp_path):
    """``test_classifier_fed`` with a streamed run's flags (``eval_cohort``:
    Local on the checkpoint's window) reproduces the Global and Local
    metrics the run logged for its best checkpoint (rtol/atol 1e-4, the
    evaluator's contract against the fused evaluation)."""
    extra = ("--client_store", "stream", "--eval_cohort", "3", "--eval_interval", "1")
    (run,) = train_classifier_fed.main(_argv(tmp_path, 3, *extra))
    (bundle,) = test_classifier_fed.main(_argv(tmp_path, 3, *extra))
    best = max(range(3), key=lambda i: run["logger"].history["test/Global-Accuracy"][i])
    for name in ("Global-Loss", "Global-Accuracy", "Local-Loss", "Local-Accuracy"):
        assert_close(f"test entry on a streamed run's best checkpoint: {name}",
                     bundle["logger_history"][f"test/{name}"][0],
                     run["logger"].history[f"test/{name}"][best], rtol=1e-4, atol=1e-4)


# --- the engines -----------------------------------------------------------------------

def _split_data(users, n_train, short=None, seed=0):
    """Synthetic MNIST, its iid split (one user's shard cut short) and the
    eager stacks of it."""
    ds = r_fetch("MNIST", synthetic=True, seed=seed, synthetic_sizes={"train": n_train,
                                                                      "test": 10})
    split, lsplit = r_split(ds, users, "iid", np.random.default_rng(0), classes_size=10)
    if short is not None:  # a client with a half-padding and an all-padding batch
        uid, n = short
        split["train"][uid] = split["train"][uid][:n]
    tr = ds["train"]
    arrays = stack_client_shards(tr.data, tr.target, split["train"], list(range(users))) + \
        (label_split_masks(lsplit, users, 10),)
    return tr, split["train"], lsplit, arrays


def _cfg(mod, control, **over):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(control)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, superstep_rounds=2,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]},
                         "batch_size": {"train": 10, "test": 10}}, **over)
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


@pytest.mark.parametrize("depth", [1, 2])
def test_cohorts_staged_ahead_equal_cohorts_staged_one_at_a_time(depth):
    """Three supersteps of the masked engine: cohorts staged one at a time,
    and cohorts staged ``depth`` supersteps ahead of the one that trains
    (the ring's slots reused while earlier cohorts are consumed) give the
    same params and sums, bit for bit."""
    cfg = _cfg(PC, "1_6_0.5_iid_fix_a1-e1_bn_1_1", stream_prefetch_depth=depth)
    tr, split, lsplit, _ = _split_data(6, 120)
    store = ClientStore.from_split(tr.data, tr.target, split, lsplit, 10)
    model = make_model(cfg).init_(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    scheds = [np.stack([rng.permutation(6)[:3] for _ in range(2)]) for _ in range(3)]

    def run(ahead):
        eng = RoundEngine(model, cfg, torch.device("cpu"))
        rates = [eng.fix_rates[s] for s in scheds]
        P, out, queue = eng.flatten(model.params()), [], []
        for i in range(3):
            while len(queue) <= ahead and len(queue) + i < 3:
                j = i + len(queue)
                queue.append(eng.stage_cohort(store, scheds[j], rates[j]))
            P, pend = eng.train_superstep(P, 0, 1 + 2 * i, 2, None, None, None, [0.05] * 2,
                                          cohort=queue.pop(0))
            out.append(pend.fetch())
        return P, out

    (P0, seq), (P1, pipe) = run(0), run(depth)
    _bits(f"cohorts staged {depth} ahead: params", P1, P0)
    for a, b in zip(pipe, seq):
        for ra, rb in zip(a, b):
            _bits(f"cohorts staged {depth} ahead: sums", ra["loss_sum"], rb["loss_sum"])


def test_grouped_cohort_slot_layout():
    """The grouped cohort's per-level layout (ref grouped.py:1305-1413):
    ``[k, L, per]`` slots, each level's slots contiguous in its users'
    order, a ``-1`` slot at user ``U - 1``'s level gathering user 0's
    shard, ``per`` the largest level's count rounded up to a power of two."""
    cfg = _cfg(PC, "1_6_1_iid_fix_a2-c2-e2_bn_1_1", strategy="grouped")
    tr, split, lsplit, arrays = _split_data(6, 120)
    store = ClientStore.from_split(tr.data, tr.target, split, lsplit, 10)
    eng = GroupedRoundEngine(make_model(cfg), cfg, torch.device("cpu"))
    users = np.array([[0, 4, 1, -1, 5], [2, 3, 0, 1, 4]])
    rates = np.asarray(cfg["model_rate"], np.float32)[users]
    coh = eng.stage_cohort(store, users, rates)
    assert tuple(coh.data[0].shape[:1]) == (2 * 3 * 4,)  # k 2, 3 levels, 3 at level e -> 4
    assert coh.rows.tolist() == [[0, 8, 1, 9, 10], [16, 17, 12, 13, 20]]
    for r in range(2):
        for i, u in enumerate(users[r]):
            np.testing.assert_array_equal(coh.data[0][coh.rows[r, i]].numpy(),
                                          arrays[0][max(u, 0)])


def _to_port(spec, rspec, perms, ref_flat):
    leaves = {n: np.asarray(v) for n, v in rspec.unflatten(jnp.asarray(ref_flat)).items()}
    return spec.flatten(params_from_jax(leaves, perms))


def test_masked_stream_superstep_matches_reference():
    """Two rounds as one streamed superstep on both sides: the reference's
    ``stage_cohort`` + ``train_superstep(cohort=...)`` and the port's, from
    the same params, cohort schedule and learning rate, with the
    reference's client draws injected; user 1's shard of 75 samples gives
    padding batches."""
    control, users = "1_4_1_iid_fix_a1-b1-c1-e1_bn_1_1", np.array([[0, 1, 2, 3], [2, 3, 0, 1]])
    rcfg, pcfg = _cfg(RC, control), _cfg(PC, control)
    tr, split, lsplit, arrays = _split_data(4, 400, short=(1, 75))
    k, E, N, lr, epoch0 = 2, 1, arrays[0].shape[1], 0.05, 3
    rmodel = r_make_model(rcfg)
    params = {n: np.asarray(v) for n, v in rmodel.init(jax.random.key(0)).items()}
    base_key = jax.random.key(7)
    reng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
    rcoh = reng.stage_cohort(RClientStore.from_split(tr.data, tr.target, split, lsplit, 10),
                             users.astype(np.int32))
    r_new, pend = reng.train_superstep({n: jnp.asarray(v) for n, v in params.items()}, base_key,
                                       epoch0, k, cohort=rcoh, lr=lr)
    r_rounds = pend.fetch()
    rspec = RFlatSpec({n: v.shape for n, v in params.items()})
    r_flat = np.asarray(rspec.flatten({n: jnp.asarray(v) for n, v in r_new.items()}))

    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params, perms))
    eng = RoundEngine(model, pcfg, torch.device("cpu"))
    keys = [jax.random.fold_in(base_key, epoch0 + r) for r in range(k)]
    draws = [reference_draws(key, users[r], E, N)[0] for r, key in enumerate(keys)]
    coh = eng.stage_cohort(ClientStore.from_split(tr.data, tr.target, split, lsplit, 10), users,
                           eng.fix_rates[users])
    P, pending = eng.train_superstep(eng.flatten(model.params()), 0, epoch0, k, None, None, None,
                                     [lr] * k, epoch_perms=draws, cohort=coh)
    rounds = pending.fetch()
    assert_close("masked streamed superstep: params after 2 rounds", P,
                 _to_port(eng.spec, rspec, perms, r_flat), rtol=0, atol=5e-5)
    for r, (ms, r_ms) in enumerate(zip(rounds, r_rounds), start=1):
        assert_close(f"masked streamed superstep round {r}: n", ms["n"], r_ms["n"], rtol=0,
                     atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"masked streamed superstep round {r}: {name}", ms[name], r_ms[name],
                         rtol=1e-4, atol=1e-4)


def test_grouped_stream_k1_int8_matches_reference():
    """One round as a streamed one-round superstep of the grouped engine
    with the int8 codec (the K=1 round the eager store refuses): the
    reference's ``stage_cohort`` + ``train_superstep(k=1, cohort=...)`` and
    the port's, with the reference's client draws and codec noise
    injected; two clients at level a, one at c, one at e, so the grid is
    sized for 3 levels x 2 slots."""
    control = "1_6_1_iid_fix_a2-c2-e2_bn_1_1"
    users = np.array([[0, 1, 2, 4]])
    rcfg = _cfg(RC, control, strategy="grouped", wire_codec="int8", error_feedback=True)
    pcfg = _cfg(PC, control, strategy="grouped", wire_codec="int8", error_feedback=True)
    tr, split, lsplit, arrays = _split_data(6, 360, short=(1, 45))
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    E, N, lr, epoch0 = 1, arrays[0].shape[1], 0.05, 3
    params = {n: np.asarray(v) for n, v in r_make_model(rcfg).init(jax.random.key(0)).items()}
    base_key = jax.random.key(7)
    reng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
    rcoh = reng.stage_cohort(RClientStore.from_split(tr.data, tr.target, split, lsplit, 10),
                             users.astype(np.int32), rates)
    r_new, pend = reng.train_superstep({n: jnp.asarray(v) for n, v in params.items()}, base_key,
                                       epoch0, 1, cohort=rcoh, lr=lr)
    (r_ms,) = pend.fetch()
    rspec = RFlatSpec({n: v.shape for n, v in params.items()})
    r_flat = np.asarray(rspec.flatten({n: jnp.asarray(v) for n, v in r_new.items()}))
    r_resid = np.asarray(reng.wire_resid_host())

    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params, perms))
    eng = GroupedRoundEngine(model, pcfg, torch.device("cpu"))
    key = jax.random.fold_in(base_key, epoch0)
    draws = reference_draws(key, users[0], E, N)[0]
    noise = _to_port(eng.spec, rspec, perms, np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0), (rspec.total,),
        jnp.float32)))
    P0 = eng.flatten(model.params())
    coh = eng.stage_cohort(ClientStore.from_split(tr.data, tr.target, split, lsplit, 10), users,
                           rates)
    P, pending = eng.train_superstep(P0, 0, epoch0, 1, None, None, None, [lr],
                                     epoch_perms=[draws], codec_noise=[noise], cohort=coh)
    (ms,) = pending.fetch()
    cmax = eng.codec_slots(rates)
    assert cmax == 6, cmax
    data = tuple(torch.from_numpy(a) for a in arrays)
    counts = torch.zeros_like(P0)
    for u, rate in zip(users[0], rates[0]):
        lv = eng.levels[float(rate)]
        counts.index_add_(0, lv.idx, lv.count_masks(data[-1][[int(u)]])[0])
    s = eng.codec.scale_flat(P0, cmax)
    resid = eng.wire_resid_host()
    assert_grid_close("grouped streamed int8 K=1: params", P,
                      _to_port(eng.spec, rspec, perms, r_flat),
                      torch.where(counts > 0, s / counts.clamp_min(1), 0.0), atol=5e-5,
                      max_share=0.02)
    assert_grid_close("grouped streamed int8 K=1: residual", resid[0],
                      _to_port(eng.spec, rspec, perms, r_resid.reshape(-1, rspec.total)[0]), s,
                      atol=5e-5 * users.shape[1], max_share=0.02)
    assert bool(np.any(resid != 0))
    assert_close("grouped streamed int8 K=1: n", ms["n"], r_ms["n"], rtol=0, atol=0)
    for name in ("loss_sum", "score_sum"):
        assert_close(f"grouped streamed int8 K=1: {name}", ms[name], r_ms[name], rtol=1e-4,
                     atol=1e-4)
    np.testing.assert_array_equal(ms["rate"], np.asarray(r_ms["rate"]))
