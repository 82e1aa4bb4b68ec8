"""Observability and its guards inside the PyTorch/CUDA port's engines and
its experiment loop, on the CPU, against the JAX reference where it draws.

Contracts:

* ``telemetry`` off / on / hist (and ``quarantine='on'`` with no poison)
  give bit-identical params and metric sums -- masked and grouped, K=1
  and K=2, the eager and the stream store, vision and LM (the reference's
  "off builds bit-identical programs", obs/__init__.py:22-23);
* a masked and a grouped superstep under ``telemetry='hist'`` and
  ``quarantine='on'``, with one client poisoned in both packages
  (``chaos_poison``), against the reference's ``train_superstep`` with its
  epoch permutations injected: the norms within the round's params
  contract, expressed relative (5e-5 of the norm plus the 5e-5 absolute
  one), participation, ``quarantined``, ``nonfinite`` and the histograms
  of levels and step fractions exact;
* the quarantine contracts of tests/test_chaos.py:299-398 on the port:
  an un-gated poison reaches the params, a gated one is a zero-count
  participant (``n`` and ``rate`` 0, ``quarantined`` 1), a clean round of
  the gated engine equals the ungated one bit for bit, the ``max_norm``
  gate quarantines every update and keeps the params;
* the experiment loop (tests/test_chaos.py:400-510, tests/test_observatory.py:
  389-484): a poisoned run under ``watchdog={'action': 'rollback'}``
  recovers, its trip before its recovery in the log and in
  ``events.jsonl``; a spent budget escalates to abort; an abort leaves the
  watchdog instant as the last event on disk; a generation with a
  non-finite carry is passed over; a ledger run resumed from its
  checkpoint equals the uninterrupted run bit for bit; a traced, ledgered,
  profiled hist run logs what the plain run logs, and its events pass the
  reference's schema.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.obs.trace import validate_event as r_validate_event
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.entry.common import FedExperiment, salt_seed
from heterofl_tpu_torch.fed.core import superstep_user_schedule
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.obs.watchdog import RETRY_SALT, WatchdogError
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.parallel.staging import ClientStore
from heterofl_tpu_torch.testing import thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint_path, save_checkpoint
from heterofl_tpu_torch.utils.checkpoint import generation_paths, load_checkpoint
from test_torch_port_round import reference_draws
from test_torch_port_stream_engines import _split_data

few_threads = thread_limit_fixture(deterministic=True)

CONTROL = "1_6_1_iid_fix_a2-c2-e2_bn_1_1"  # users 0, 1 at level a; 2, 3 at c; 4, 5 at e
USERS = np.array([[0, 2, -1, 4], [3, 5, 1, 0]])
LR, EPOCH0 = 0.05, 3
MODES = {"off": {}, "on": {"telemetry": "on"}, "hist": {"telemetry": "hist"},
         "quarantine": {"quarantine": "on"}}


def _cfg(mod, strategy="masked", k=2, **over):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, strategy=strategy,
               superstep_rounds=k, override={"num_epochs": {"local": 1},
                                             "conv": {"hidden_size": [8, 16]}}, **over)
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def _lm_cfg(strategy, **over):
    from test_torch_port_lm import _cfg as lm_cfg

    return dict(lm_cfg(PC, "1_6_1_iid_fix_a2-c2-e2_bn_1_1"), strategy=strategy,
                superstep_rounds=2, **over)


@pytest.fixture(scope="module")
def vision():
    tr, split, lsplit, arrays = _split_data(6, 180, short=(1, 15))
    return ClientStore.from_split(tr.data, tr.target, split, lsplit, 10), arrays


def _run(cfg, data, store, k, users, lm=False):
    """One engine of ``cfg`` from the same init: ``train_round`` at K=1 on
    the eager store, else one superstep of ``k`` rounds (a staged cohort on
    the stream store) -> (params, fetched metrics)."""
    engine = GroupedRoundEngine if cfg["strategy"] == "grouped" else RoundEngine
    model = make_model(cfg).init_(torch.Generator().manual_seed(0))
    eng = engine(model, cfg, torch.device("cpu"))
    P = eng.flatten(model.params())
    users = users[:k]
    rates = np.asarray(cfg["model_rate"], np.float32)[users]
    if k == 1 and store is None:
        P, ms = eng.train_round(P, LR, users[0], data, 11)
        return P, {n: (v.numpy() if torch.is_tensor(v) else v) for n, v in ms.items()}
    if store is None:
        return P_fetch(eng.train_superstep(P, 0, EPOCH0, k, data, users, rates, [LR] * k))
    cohort = eng.stage_cohort(store, users, rates)
    return P_fetch(eng.train_superstep(P, 0, EPOCH0, k, None, None, None, [LR] * k,
                                       cohort=cohort))


def P_fetch(out):
    P, pending = out
    return P, pending.fetch()


def _rows_records(out):
    """A fetch's per-round metric dicts and probe records (None without):
    a K=1 round's ``obs_*`` rows finished as the experiment loop finishes them."""
    if isinstance(out, dict) and "train" not in out:  # train_round's metrics
        if not any(n.startswith("obs_") for n in out):
            return [out], None
        from heterofl_tpu_torch.obs import split_probes

        clean, rec = split_probes(out, sorted({1.0, 0.25, 0.0625}, reverse=True))
        return [clean], [rec]
    if isinstance(out, dict):
        return out["train"], out.get("obs")
    return out, None


CASES = [("masked", "eager", 1), ("masked", "eager", 2), ("masked", "stream", 1),
         ("masked", "stream", 2), ("grouped", "eager", 2), ("grouped", "stream", 1),
         ("grouped", "stream", 2), ("masked", "lm", 2), ("grouped", "lm", 2)]


@pytest.mark.parametrize("strategy,store,k", CASES)
def test_telemetry_modes_leave_the_round_bit_for_bit(vision, strategy, store, k):
    """off, on, hist and the quarantine gate: the same params and sums bit
    for bit; the on/hist records carry the reference's fields."""
    cohorts, arrays = vision
    outs = {}
    for name, mode in MODES.items():
        if store == "lm":
            cfg = _lm_cfg(strategy, **mode)
            rng = np.random.default_rng(0)
            data = (torch.from_numpy(rng.integers(0, 50, (6, 2, 40)).astype(np.int64)),
                    torch.ones((6, cfg["num_tokens"]), dtype=torch.float32))
            outs[name] = _run(cfg, data, None, k, np.maximum(USERS, 0))
            continue
        cfg = _cfg(PC, strategy, k=k, client_store="stream" if store == "stream" else "eager",
                   **mode)
        data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
        outs[name] = _run(cfg, data, cohorts if store == "stream" else None, k, USERS)
    P0, out0 = outs["off"]
    rows0, recs0 = _rows_records(out0)
    assert recs0 is None
    for name, (P, out) in outs.items():
        assert torch.equal(P, P0), name
        rows, recs = _rows_records(out)
        assert len(rows) == k and (recs is None) == (name == "off")
        for r, (a, b) in enumerate(zip(rows, rows0)):
            for n in ("loss_sum", "score_sum", "n", "rate"):
                np.testing.assert_array_equal(a[n], b[n], err_msg=f"{name} round {r}: {n}")
        if name != "off":
            assert len(recs) == k
            fields = {"on": 6, "hist": 10, "quarantine": 1}[name]
            assert len(recs[0]) == fields and all(rec.get("quarantined", 0) == 0 for rec in recs)
            assert all(rec.get("nonfinite", 0) == 0 for rec in recs)


def _reference_superstep(strategy, arrays, params, poison):
    rcfg = _cfg(RC, strategy, telemetry="hist", quarantine="on", chaos_poison=poison)
    rdata = tuple(jnp.asarray(a) for a in arrays)
    rp = {n: jnp.asarray(v) for n, v in params.items()}
    base = jax.random.key(7)
    k = USERS.shape[0]
    if strategy == "masked":
        reng = RRoundEngine(r_make_model(rcfg), rcfg, make_mesh(1, 1))
        r_new, pend = reng.train_superstep(rp, base, EPOCH0, k, rdata, user_schedule=USERS,
                                           lr=LR)
    else:
        rates = np.asarray(rcfg["model_rate"], np.float32)[USERS]
        reng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
        r_new, pend = reng.train_superstep(rp, base, EPOCH0, k, USERS, rates, rdata, lr=LR)
    keys = [jax.random.fold_in(base, EPOCH0 + r) for r in range(k)]
    E, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    perms = [reference_draws(key, np.maximum(USERS[r], 0), E, N)[0] for r, key in enumerate(keys)]
    return pend.fetch(), perms


@pytest.mark.parametrize("strategy", ["masked", "grouped"])
def test_probes_match_reference_superstep(vision, strategy):
    """Round 4's user 1 poisoned in both packages under the gate: the
    records agree field by field."""
    _, arrays = vision
    poison = [[EPOCH0 + 1, 1]]
    rcfg = _cfg(RC, strategy)
    params = {n: np.asarray(v) for n, v in r_make_model(rcfg).init(jax.random.key(0)).items()}
    ref, perms = _reference_superstep(strategy, arrays, params, poison)
    pcfg = _cfg(PC, strategy, telemetry="hist", quarantine="on", chaos_poison=poison)
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params, model.jax_perms()))
    eng = (RoundEngine if strategy == "masked" else GroupedRoundEngine)(model, pcfg,
                                                                        torch.device("cpu"))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    rates = np.asarray(pcfg["model_rate"], np.float32)[USERS]
    P, pend = eng.train_superstep(eng.flatten(model.params()), 0, EPOCH0, 2, data, USERS, rates,
                                  [LR] * 2, epoch_perms=perms)
    out = pend.fetch()
    assert bool(torch.isfinite(P).all())
    for r, (rec, r_rec) in enumerate(zip(out["obs"], ref["obs"])):
        assert set(rec) == set(r_rec), r
        for name in ("update_norm", "grad_norm"):
            assert abs(rec[name] - r_rec[name]) <= 5e-5 * r_rec[name] + 5e-5, (r, name)
            print(f"parity {strategy} superstep round {r + 1} {name}: port {rec[name]:.7g} "
                  f"reference {r_rec[name]:.7g}")
        for name in ("participation", "quarantined", "nonfinite", "hist_level", "hist_steps",
                     "hist_stale", "resid_norm", "stale_norm"):
            assert rec[name] == r_rec[name], (r, name)
        np.testing.assert_array_equal(out["train"][r]["n"], np.asarray(ref["train"][r]["n"]))
        np.testing.assert_array_equal(out["train"][r]["rate"],
                                      np.asarray(ref["train"][r]["rate"]))
    assert [rec["quarantined"] for rec in out["obs"]] == [0, 1]
    poisoned = list(USERS[1]).index(1)
    assert out["train"][1]["n"][poisoned] == 0 and out["train"][1]["rate"][poisoned] == 0


def test_masked_k1_poison_quarantined(vision):
    """Un-gated, the poison reaches the params; gated, the client is a
    zero-count participant and the round's params are finite; a clean
    round of the gated engine is the ungated round bit for bit."""
    _, arrays = vision
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    users = np.array([0, 2, 4, 5])

    def engine(**over):
        cfg = _cfg(PC, k=1, **over)
        model = make_model(cfg).init_(torch.Generator().manual_seed(0))
        return RoundEngine(model, cfg, torch.device("cpu")), model

    bad, model = engine(chaos_poison=[[1, 2]])
    P0 = bad.flatten(model.params())
    with pytest.raises(ValueError, match="epoch="):
        bad.train_round(P0, LR, users, data, 5)
    P_bad, _ = bad.train_round(P0, LR, users, data, 5, epoch=1)
    assert not bool(torch.isfinite(P_bad).all())
    gated, _ = engine(chaos_poison=[[1, 2]], quarantine="on", telemetry="on")
    P_q, ms = gated.train_round(P0, LR, users, data, 5, epoch=1)
    assert bool(torch.isfinite(P_q).all())
    from heterofl_tpu_torch.obs import split_probes

    host = {n: (v.numpy() if torch.is_tensor(v) else v) for n, v in ms.items()}
    clean, rec = split_probes(host, gated.obs_levels)
    assert rec["quarantined"] == 1 and rec["nonfinite"] == 0
    assert clean["n"][1] == 0 and clean["rate"][1] == 0 and (clean["n"][[0, 2, 3]] > 0).all()
    plain, _ = engine()
    P1, _ = gated.train_round(P0, LR, users, data, 5, epoch=2)
    P2, _ = plain.train_round(P0, LR, users, data, 5)
    assert torch.equal(P1, P2)


@pytest.mark.parametrize("strategy", ["masked", "grouped"])
def test_superstep_poison_quarantined_and_max_norm(vision, strategy):
    """A poisoned (round, uid) of a superstep is gated in its round only;
    a ``max_norm`` of 1e-12 quarantines every update and keeps the
    params (the stale fallback)."""
    _, arrays = vision
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    for over, want in (({"chaos_poison": [[EPOCH0 + 1, 5]], "quarantine": "on"}, [0, 1]),
                       ({"quarantine": {"max_norm": 1e-12}}, [3, 4])):
        cfg = _cfg(PC, strategy, **over)
        model = make_model(cfg).init_(torch.Generator().manual_seed(0))
        eng = (RoundEngine if strategy == "masked" else GroupedRoundEngine)(
            model, cfg, torch.device("cpu"))
        P0 = eng.flatten(model.params())
        rates = np.asarray(cfg["model_rate"], np.float32)[USERS]
        P, pend = eng.train_superstep(P0.clone(), 0, EPOCH0, 2, data, USERS, rates, [LR] * 2)
        out = pend.fetch()
        assert [rec["quarantined"] for rec in out["obs"]] == want, over
        assert bool(torch.isfinite(P).all())
        if "max_norm" in str(over):
            assert torch.equal(P, P0)
            assert all((r["rate"] == 0).all() and (r["n"] == 0).all() for r in out["train"])


# --- the experiment loop ------------------------------------------------------------------------

def _run_cfg(out, **over):
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_20_0.2_iid_fix_a1-b1_bn_1_1")
    cfg.update({"data_name": "MNIST", "model_name": "conv", "synthetic": True, "device": "cpu",
                "synthetic_sizes": {"train": 200, "test": 40}, "output_dir": str(out),
                "superstep_rounds": 2, "eval_interval": 2,
                "override": {"num_epochs": {"global": 4, "local": 1},
                             "conv": {"hidden_size": [4, 8]}}, **over})
    return PC.process_control(cfg)


def _log(exp):
    path = os.path.join(exp.cfg["output_dir"], "runs", f"train_{exp.tag}", "log.jsonl")
    return [json.loads(line) for line in open(path)]


def _pick_poison_uid(tmp_path, **over):
    """A user of round 3's cohort whom the first rollback's salted redraw
    of round 3 leaves out: the clean run's cohort, and the draw the loop
    makes after restoring the epoch-3 generation (its permutation stream at
    the boundary, both streams salted with ``RETRY_SALT + 1``)."""
    exp = FedExperiment(_run_cfg(tmp_path / "clean", **over), 0)
    res = exp.run()
    blob = next(b for b in map(load_checkpoint, generation_paths(
        checkpoint_path(exp.cfg["output_dir"], exp.tag))) if b["epoch"] == 3)
    rng = np.random.default_rng()
    rng.bit_generator.state = blob["sampler_state"]
    salt = RETRY_SALT + 1
    rng = np.random.default_rng([salt, *rng.integers(0, 2 ** 32, 2).tolist()])
    redraw = superstep_user_schedule(salt_seed(0, salt), 3, 2, 20, exp.num_active, "perm", rng,
                                     exp.sched)[0]
    return next(u for u in res["history"][2]["users"] if u not in redraw)


STREAM8 = {"client_store": "stream", "stream_prefetch_depth": 2,
           "override": {"num_epochs": {"global": 8, "local": 1}, "conv": {"hidden_size": [4, 8]}}}


@pytest.mark.parametrize("store", [{}, STREAM8])
def test_run_rollback_recovers_from_poison(tmp_path, store):
    """Eager (4 rounds), and streamed (8 rounds) with the cohorts of rounds
    5-8 prefetched into the ring when round 3's trip surfaces: the rollback
    releases them (the replay refills their slots, which the ring refuses
    for a cohort nobody released) and restores the permutation stream's
    boundary."""
    # four rounds draw the same first cohorts and keep the epoch-3 generation
    uid = _pick_poison_uid(tmp_path, **{k: v for k, v in store.items() if k != "override"})
    trace_dir = str(tmp_path / "trace")
    cfg = _run_cfg(tmp_path / "run", chaos_poison=[[3, int(uid)]], telemetry="on",
                      trace_dir=trace_dir, ledger="on",
                      watchdog={"action": "rollback", "max_retries": 3, "backoff": 0.0},
                      **store)
    exp = FedExperiment(cfg, 0)
    with pytest.warns(UserWarning, match="rollback attempt"):
        res = exp.run()
    assert all(bool(torch.isfinite(v).all()) for v in res["params"].values())
    log = _log(exp)
    trips = [i for i, r in enumerate(log) if r.get("tag") == "obs" and r.get("event") == "watchdog"]
    recs = [i for i, r in enumerate(log) if r.get("tag") == "recovery"]
    assert len(trips) == 1 and len(recs) == 1 and trips[0] < recs[0]
    assert log[recs[0]]["attempt"] == 1 and log[recs[0]]["restored_epoch"] == 3
    assert exp._rollback_attempts == 0
    rounds = cfg["num_epochs"]["global"]
    assert [r["epoch"] for r in res["history"]] == list(range(1, rounds + 1))
    assert uid not in res["history"][2]["users"]
    events = [json.loads(line) for line in open(os.path.join(trace_dir, exp.tag,
                                                             "events.jsonl"))]
    names = [e["name"] for e in events]
    assert names.index("watchdog") < names.index("recovery")
    assert all(r_validate_event(e) == e for e in events)
    assert os.path.exists(os.path.join(trace_dir, exp.tag, "ledger.npz"))


def test_run_rollback_budget_escalates_to_abort(tmp_path):
    cfg = _run_cfg(tmp_path, chaos_poison=[[r, u] for r in (3, 4) for u in range(20)],
                      telemetry="on",
                      watchdog={"action": "rollback", "max_retries": 2, "backoff": 0.0})
    exp = FedExperiment(cfg, 0)
    with pytest.warns(UserWarning):
        with pytest.raises(WatchdogError, match="budget spent"):
            exp.run()
    assert len([r for r in _log(exp) if r.get("tag") == "recovery"]) == 2


def test_run_abort_leaves_the_trip_last_on_disk(tmp_path):
    trace_dir = str(tmp_path / "trace")
    cfg = _run_cfg(tmp_path, chaos_poison=[[r, u] for r in (3,) for u in range(20)],
                      telemetry="on", trace_dir=trace_dir, ledger="on",
                      watchdog={"action": "abort"})
    exp = FedExperiment(cfg, 0)
    with pytest.warns(UserWarning, match="nonfinite"):
        with pytest.raises(WatchdogError, match="watchdog abort at round 3"):
            exp.run()
    lines = open(os.path.join(trace_dir, exp.tag, "events.jsonl")).read().splitlines()
    assert json.loads(lines[-1])["name"] == "watchdog"
    json.load(open(os.path.join(trace_dir, exp.tag, "trace.json")))
    assert os.path.exists(os.path.join(trace_dir, exp.tag, "ledger.npz"))


def test_rollback_blob_passes_over_nonfinite_carries(tmp_path):
    exp = FedExperiment(_run_cfg(tmp_path), 0)
    path = checkpoint_path(exp.cfg["output_dir"], exp.tag)
    good = {"epoch": 2, "params": {"w": np.ones(4, np.float32)}, "sched_buf": None}
    bad = {"epoch": 3, "params": {"w": np.ones(4, np.float32)},
           "sched_buf": np.full((2, 4), np.nan, np.float32)}
    save_checkpoint(path, good, keep=3)
    save_checkpoint(path, bad, keep=3)
    with pytest.warns(UserWarning, match="non-finite params or carries"):
        assert exp._load_rollback_blob()["epoch"] == 2


def test_run_ledger_resume_equals_uninterrupted(tmp_path):
    """Rounds 1-4 in one run, and rounds 1-2 then 3-4 resumed from the
    checkpoint: the same ledger arrays and params bit for bit."""
    full = FedExperiment(_run_cfg(tmp_path / "full", ledger="on"), 0)
    res = full.run()
    cut_cfg = _run_cfg(tmp_path / "cut", ledger="on")
    cut_cfg["num_epochs"] = dict(cut_cfg["num_epochs"], **{"global": 2})
    FedExperiment(cut_cfg, 0).run()
    resumed = FedExperiment(_run_cfg(tmp_path / "cut", ledger="on", resume_mode=1), 0)
    res2 = resumed.run()
    a, b = full.ledger.state_dict(), resumed.ledger.state_dict()
    assert a["meta"] == b["meta"] and a["meta"]["round"] == 4
    for f in ("count", "last_seen", "stale_sum", "loss_ema", "level_last", "level_counts"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert all(torch.equal(res["params"][k], v) for k, v in res2["params"].items())
    assert os.path.exists(os.path.join(tmp_path / "full", "obs", full.tag, "ledger.npz"))


def test_run_observed_run_logs_what_the_plain_run_logs(tmp_path):
    """hist, the gate, the ledger, the trace and a profile of the first
    steady superstep: the params, cohorts and metric log of the plain
    run; probe, watchdog-free and ledger events beside them; the K=1 path
    the same."""
    for k in (2, 1):
        plain = FedExperiment(_run_cfg(tmp_path / f"plain{k}", superstep_rounds=k), 0)
        res0 = plain.run()
        obs = FedExperiment(_run_cfg(
            tmp_path / f"obs{k}", superstep_rounds=k, telemetry="hist", quarantine="on",
            ledger="on", trace_dir=str(tmp_path / f"trace{k}"),
            profile_dir=str(tmp_path / f"prof{k}")), 0)
        res1 = obs.run()
        assert all(torch.equal(res0["params"][n], v) for n, v in res1["params"].items())
        assert [r["users"] for r in res0["history"]] == [r["users"] for r in res1["history"]]
        strip = lambda log: [{n: v for n, v in r.items() if n != "t"} for r in log  # noqa: E731
                             if r["tag"] in ("train", "test")]
        assert strip(_log(plain)) == strip(_log(obs))
        events = [r for r in _log(obs) if r["tag"] in ("obs", "ledger")]
        assert [r["epoch"] for r in events if r.get("event") == "probes"] == [1, 2, 3, 4]
        assert len([r for r in events if r["tag"] == "ledger"]) == 4 // k
        assert all(len(r["hist_loss"]) == 11 for r in events if r.get("event") == "probes")
        assert os.path.exists(obs.profile_path) and json.load(open(obs.profile_path))
        tdir = tmp_path / f"trace{k}" / obs.tag
        trace = json.load(open(tdir / "trace.json"))
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"run-start", "dispatch", "fetch", "probes", "ledger", "checkpoint",
                "superstep" if k > 1 else "round"} <= names
        for line in open(tdir / "events.jsonl"):
            rec = json.loads(line)
            assert r_validate_event(rec) == rec
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert obs.watchdog is not None and obs.watchdog.fired == []
