"""Observability and its guards in the PyTorch/CUDA port, function by
function against the JAX reference on the CPU: the same inputs, made from a
seed with numpy, through both packages.

* ``round_probes`` on the port's flat buffer against the reference's on a
  params dict: the squared norms at rtol 1e-6, ``nonfinite`` (LEAVES
  holding a NaN or an infinity) exact;
* the quarantine gate, row by row, exact; the chaos poison's rows exact;
* ``bucket_counts`` / ``round_hists`` (the deadline's step fractions, the
  staleness carry's magnitudes on the device): counts exact, edge values
  included;
* ``split_probes``: the port's record (device rows finished on the host)
  has the reference's fields and values;
* the ``Watchdog``: the same trips (and exceptions) on the same probe and
  loss sequences, for warn, abort and rollback;
* the ``ClientLedger``: the same ``state_dict`` bit for bit after the same
  folds (``-1`` and failed slots among them), each package loading the
  other's ``ledger.npz``, the two reports' ``--json`` equal;
* the trace: every ``events.jsonl`` line the port writes passes the
  reference's ``validate_event``; ``trace.json`` loads;
* the validators: every refusal of the reference's config tests
  (tests/test_obs.py:298, tests/test_observatory.py:261,
  tests/test_chaos.py:59-80) with the same message.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu import obs as R_obs
from heterofl_tpu.chaos import resolve_poison_cfg as r_resolve_poison
from heterofl_tpu.chaos.inject import poison_updates as r_poison_updates
from heterofl_tpu.obs import hist as R_hist
from heterofl_tpu.obs import report as R_report
from heterofl_tpu.obs.ledger import ClientLedger as RClientLedger
from heterofl_tpu.obs.probes import quarantine_gate as r_quarantine_gate
from heterofl_tpu.obs.probes import round_probes as r_round_probes
from heterofl_tpu.obs.trace import validate_event as r_validate_event
from heterofl_tpu.obs.watchdog import Watchdog as RWatchdog
from heterofl_tpu.sched.deadline import deadline_steps as r_deadline_steps
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch import obs as P_obs
from heterofl_tpu_torch.chaos import resolve_poison_cfg as p_resolve_poison
from heterofl_tpu_torch.chaos.inject import poison_hits, poison_updates
from heterofl_tpu_torch.obs import hist as P_hist
from heterofl_tpu_torch.obs import report as P_report
from heterofl_tpu_torch.obs.ledger import LEDGER_FIELDS, ClientLedger
from heterofl_tpu_torch.obs.probes import quarantine_gate, round_probes, segment_ends
from heterofl_tpu_torch.obs.trace import TraceRecorder
from heterofl_tpu_torch.obs.watchdog import Watchdog, WatchdogError, WatchdogRollback
from heterofl_tpu_torch.ops.fused_update import FlatSpec
from heterofl_tpu_torch.parallel.staging import PhaseTimer
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

SHAPES = {"a.w": (6, 5), "b.b": (7,), "c.k": (3, 2, 4), "d": (1,)}
LEVELS = [1.0, 0.5, 0.25]


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _flat(spec, tree):
    return spec.flatten({k: torch.from_numpy(v) for k, v in tree.items()})


def _probe_inputs(seed, bad_leaves=()):
    """Params before/after, post-codec sums and counts, a residual and a
    staleness carry from ``seed``; ``bad_leaves`` of the new params get a
    NaN (first) and an infinity (second)."""
    rng = np.random.default_rng(seed)
    p, new = _tree(rng), _tree(rng, 0.1)
    new = {k: p[k] + v for k, v in new.items()}
    counts = {k: rng.integers(0, 4, s).astype(np.float32) for k, s in SHAPES.items()}
    summed = {k: (p[k] + rng.standard_normal(s).astype(np.float32) * 0.05) * counts[k]
              for k, s in SHAPES.items()}
    for i, k in enumerate(bad_leaves):
        flat = new[k].reshape(-1)
        flat[i % flat.size] = np.nan if i == 0 else np.inf
    resid = rng.standard_normal((1, sum(int(np.prod(s)) for s in SHAPES.values())))
    buf = rng.standard_normal((2, resid.shape[1])).astype(np.float32) * 1e-3
    return p, new, summed, counts, resid.astype(np.float32), buf


@pytest.mark.parametrize("bad", [(), ("b.b",), ("a.w", "a.w", "d")])
def test_round_probes_match_reference(bad):
    """Norms at rtol 1e-6 on finite params; the non-finite LEAF count exact
    (two bad elements in one leaf count once)."""
    p, new, summed, counts, resid, buf = _probe_inputs(3, bad)
    rate = np.asarray([1.0, 0.5, 0.5, 0.0], np.float32)
    ref = r_round_probes(LEVELS, {k: jnp.asarray(v) for k, v in p.items()},
                         {k: jnp.asarray(v) for k, v in new.items()},
                         {k: jnp.asarray(v) for k, v in summed.items()},
                         {k: jnp.asarray(v) for k, v in counts.items()}, jnp.asarray(rate),
                         resid=jnp.asarray(resid), sched_buf=jnp.asarray(buf))
    spec = FlatSpec(SHAPES)
    got = round_probes(segment_ends(spec, torch.device("cpu")), _flat(spec, p),
                       _flat(spec, new), _flat(spec, summed), _flat(spec, counts),
                       torch.from_numpy(resid), torch.from_numpy(buf))
    assert int(got["obs_nonfinite"]) == int(ref["obs_nonfinite"][0]) == len(set(bad))
    for name in ("obs_grad_sq", "obs_resid_sq", "obs_stale_sq") + (
            () if bad else ("obs_update_sq",)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-6,
                                   err_msg=name)
    if bad:
        assert not np.isfinite(got["obs_update_sq"].numpy()).any()


def test_probes_without_carries_are_zero():
    p, new, summed, counts, _, _ = _probe_inputs(5)
    spec = FlatSpec(SHAPES)
    got = round_probes(segment_ends(spec, torch.device("cpu")), _flat(spec, p),
                       _flat(spec, new), _flat(spec, summed), _flat(spec, counts))
    assert float(got["obs_resid_sq"]) == 0.0 and float(got["obs_stale_sq"]) == 0.0


@pytest.mark.parametrize("max_norm", [None, 0.5])
def test_quarantine_gate_matches_reference(max_norm):
    """Four slots: clean, a NaN, an infinity, a large update -- the gate
    row bit for bit the reference's (rows of ``[S, n]`` in the port)."""
    rng = np.random.default_rng(1)
    ref_p = _tree(rng)
    trained = {k: np.stack([v + rng.standard_normal(v.shape).astype(np.float32) * s
                            for s in (0.01, 0.01, 0.01, 1.0)]) for k, v in ref_p.items()}
    trained["b.b"][1, 2] = np.nan
    trained["c.k"][2, 0, 1, 3] = -np.inf
    cms = {k: (rng.random((4,) + v.shape) > 0.3).astype(np.float32) for k, v in ref_p.items()}
    ref = np.asarray(r_quarantine_gate({k: jnp.asarray(v) for k, v in trained.items()},
                                       {k: jnp.asarray(v) for k, v in ref_p.items()},
                                       {k: jnp.asarray(v) for k, v in cms.items()}, max_norm))
    spec = FlatSpec(SHAPES)
    rows = lambda t: torch.stack([_flat(spec, {k: v[i] for k, v in t.items()})  # noqa: E731
                                  for i in range(4)])
    got = quarantine_gate(rows(trained), _flat(spec, ref_p), rows(cms), max_norm)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.tolist() == ([True, False, False, True] if max_norm is None
                            else [True, False, False, False])
    one = quarantine_gate(rows(trained)[3], _flat(spec, ref_p), rows(cms)[3], max_norm)
    assert one.dim() == 0 and bool(one) == bool(ref[3])


def test_poison_matches_reference():
    """The (round, uid) table, its refusals and the poisoned rows."""
    table = p_resolve_poison({"chaos_poison": [[3, 1], [4, 0], [3, 5]]})
    np.testing.assert_array_equal(table, r_resolve_poison({"chaos_poison": [[3, 1], [4, 0],
                                                                            [3, 5]]}))
    uids = np.array([5, -1, 1, 2])
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    ref = np.asarray(r_poison_updates({"w": jnp.asarray(x)}, table, jnp.int32(3),
                                      jnp.asarray(uids))["w"])
    got = poison_updates(torch.from_numpy(x), poison_hits(table, 3, uids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got[~np.isnan(got)], ref[~np.isnan(ref)])
    assert not poison_hits(table, 2, uids).any()
    assert poison_updates(torch.ones(3), np.zeros(1, bool)).eq(1).all()


@pytest.mark.parametrize("edges", ["LOSS_EDGES", "STEP_EDGES", "STALE_EDGES"])
def test_bucket_counts_match_reference(edges):
    """Every edge value itself, the float32 neighbours on both sides, zero,
    negatives and the overflow: counts exact, on the host and (the
    staleness carry's kernel-free path) on the device tensor."""
    e = np.asarray(getattr(R_hist, edges), np.float32)
    assert tuple(getattr(P_hist, edges)) == tuple(getattr(R_hist, edges))
    vals = np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                           np.nextafter(e, np.float32(-np.inf)),
                           np.asarray([0.0, -1.0, 1e9, 0.03], np.float32)]).astype(np.float32)
    w = np.random.default_rng(2).integers(0, 3, vals.size).astype(np.float32)
    ref = np.asarray(R_hist.bucket_counts(jnp.asarray(vals), jnp.asarray(w), tuple(e)))
    np.testing.assert_array_equal(P_hist.bucket_counts(vals, w, tuple(e)), ref)
    if edges == "STALE_EDGES":
        mag = np.abs(vals)
        ref1 = np.asarray(R_hist.bucket_counts(jnp.asarray(mag), jnp.ones(mag.size), tuple(e)))
        dev = P_hist.stale_hist(torch.from_numpy(vals).reshape(2, -1), torch.device("cpu"))
        np.testing.assert_array_equal(dev[0].numpy() * 2.0 ** 24 + dev[1].numpy(), ref1)


def test_round_hists_match_reference():
    """Loss, step-fraction (a deadline's budgets at the reference's key),
    level and staleness histograms of one round, exact."""
    rng = np.random.default_rng(7)
    S, total, min_frac = 12, 9, 0.3
    rate = rng.choice([1.0, 0.5, 0.25, 0.0], S).astype(np.float32)
    n = rng.integers(0, 40, S).astype(np.float32)
    n[3] = 0.0
    loss = (rng.random(S) * 6).astype(np.float32) * n
    uids = rng.integers(0, 50, S)
    buf = (rng.standard_normal((2, 40)) * 10.0 ** rng.integers(-9, 3, (2, 40))).astype(np.float32)
    buf[0, :3] = 0.0
    key = jax.random.key(5)
    ref = R_hist.round_hists(LEVELS, jnp.asarray(rate), jnp.asarray(loss), jnp.asarray(n),
                             key=key, uids=jnp.asarray(uids), total_steps=total,
                             min_frac=min_frac, sched_buf=jnp.asarray(buf))
    budgets = np.asarray(r_deadline_steps(key, jnp.asarray(uids), total, min_frac))
    got = P_hist.round_hists(LEVELS, rate, loss, n,
                             budgets.astype(np.float32) / np.float32(total), buf)
    for name in P_obs.HIST_FIELDS:
        np.testing.assert_array_equal(got[name], np.asarray(ref["obs_" + name]), err_msg=name)
    ref0 = R_hist.round_hists(LEVELS, jnp.asarray(rate), jnp.asarray(loss), jnp.asarray(n))
    got0 = P_hist.round_hists(LEVELS, rate, loss, n)
    for name in P_obs.HIST_FIELDS:
        np.testing.assert_array_equal(got0[name], np.asarray(ref0["obs_" + name]), err_msg=name)


def test_split_probes_records_match_reference():
    """One round's record from each package's rows -- the reference's
    in-program leaves through its ``split_probes``, the port's device rows
    and host rows through its own: the same fields, the same values (norms
    rtol 1e-6, counts exact); a gated slot's row and rate read 0."""
    p, new, summed, counts, resid, buf = _probe_inputs(11)
    rng = np.random.default_rng(11)
    S = 6
    rates_abs = np.asarray([1.0, 0.5, 0.5, 0.25, 1.0, 0.25], np.float32)
    valid = np.asarray([1, 1, 0, 1, 1, 1], np.float32)
    ok = np.asarray([1, 0, 1, 1, 1, 1], np.float32)
    loss = (rng.random(S) * 3).astype(np.float32) * 10
    nn = np.full(S, 10.0, np.float32)
    # the reference's round: the gate zeroes the quarantined slot's row and rate
    r_ms = {"loss_sum": loss * ok * valid, "score_sum": loss * ok * valid, "n": nn * ok * valid,
            "rate": rates_abs * valid * ok,
            "obs_quarantine": np.asarray([np.sum(valid * (1 - ok))], np.float32)}
    tj = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    r_ms.update({k: np.asarray(v) for k, v in r_round_probes(
        LEVELS, tj(p), tj(new), tj(summed), tj(counts), jnp.asarray(r_ms["rate"]),
        resid=jnp.asarray(resid), sched_buf=jnp.asarray(buf)).items()})
    r_ms.update({k: np.asarray(v) for k, v in R_hist.round_hists(
        LEVELS, jnp.asarray(r_ms["rate"]), jnp.asarray(r_ms["loss_sum"]),
        jnp.asarray(r_ms["n"]), sched_buf=jnp.asarray(buf)).items()})
    r_clean, r_recs = R_obs.split_probes(r_ms, 1)
    # the port's round: the engine's rows before the gate; split applies it
    spec = FlatSpec(SHAPES)
    dev = round_probes(segment_ends(spec, torch.device("cpu")), _flat(spec, p),
                       _flat(spec, new), _flat(spec, summed), _flat(spec, counts),
                       torch.from_numpy(resid), torch.from_numpy(buf))
    p_ms = {"loss_sum": loss * valid, "score_sum": loss * valid, "n": nn * valid,
            "rate": rates_abs * valid, "obs_gate": ok,
            "obs_hist_stale": P_hist.stale_hist(torch.from_numpy(buf), torch.device("cpu")),
            **dev}
    clean, rec = P_obs.split_probes({k: np.asarray(v) for k, v in p_ms.items()}, LEVELS)
    assert set(rec) == set(r_recs[0]) == set(P_obs.PROBE_FIELDS) | set(P_obs.HIST_FIELDS)
    for name, ref in r_recs[0].items():
        if isinstance(ref, float):
            np.testing.assert_allclose(rec[name], ref, rtol=1e-6, err_msg=name)
        else:
            assert rec[name] == ref, name
    assert rec["quarantined"] == 1
    for name in ("loss_sum", "score_sum", "n", "rate"):
        np.testing.assert_array_equal(clean[name], r_clean[name], err_msg=name)
    # the quarantine alone (telemetry off): the record holds its count only
    _, only = P_obs.split_probes({"loss_sum": loss, "score_sum": loss, "n": nn,
                                  "rate": rates_abs, "obs_gate": ok}, LEVELS)
    _, r_only = R_obs.split_probes({"rate": rates_abs, "obs_quarantine": np.ones(1)}, 1)
    assert only == r_only[0] == {"quarantined": 1}
    assert P_obs.split_probes({"rate": rates_abs}, LEVELS)[1] is None


def _watch_sequence():
    """(epoch, probes, loss) rounds: a warm-up, a spike, a NaN loss, a
    non-finite params count."""
    seq = [(e, {"nonfinite": 0}, loss) for e, loss in enumerate([2.0, 1.9, 1.8, 1.85, 1.7], 1)]
    return seq + [(6, {"nonfinite": 0}, 9.0), (7, {"nonfinite": 0}, float("nan")),
                  (8, {"nonfinite": 2}, 1.6), (9, None, None)]


@pytest.mark.parametrize("action", ["warn", "abort", "rollback"])
def test_watchdog_trips_match_reference(action):
    """The same trips, events and exceptions (type, message) round by round."""
    spec = {"telemetry": "on", "watchdog": {"action": action, "window": 4}}
    r_wd = RWatchdog(R_obs.resolve_telemetry_cfg(spec).watchdog)
    p_wd = Watchdog(P_obs.resolve_telemetry_cfg(spec).watchdog)
    for epoch, probes, loss in _watch_sequence():
        outs = []
        for wd in (r_wd, p_wd):
            emitted = []
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    outs.append(("ok", wd.check(epoch, probes=probes, loss=loss,
                                                emit=emitted.append), emitted))
                except Exception as e:  # noqa: BLE001 -- compared below
                    outs.append((type(e).__name__, str(e), emitted))
        assert outs[0] == outs[1], epoch
    assert r_wd.fired == p_wd.fired and len(p_wd.fired) == 3
    p_wd.reset_window()
    assert p_wd.fired and not p_wd._losses
    assert issubclass(WatchdogRollback, WatchdogError)


def _ledger_folds(led):
    rng = np.random.default_rng(9)
    U = led.num_users
    for epoch in range(1, 7):
        uids = rng.choice(U, size=5, replace=False).astype(np.int64)
        uids[epoch % 5] = -1  # a padding slot
        rates = rng.choice(LEVELS, 5).astype(np.float32)
        rates[(epoch + 2) % 5] = 0.0  # a failed (or gated) slot
        ns = rng.integers(0, 20, 5).astype(np.float32)
        led.update(epoch * 2, uids, rates, rng.random(5).astype(np.float32) * 3 * ns, ns)
    return led


def test_ledger_state_matches_reference(tmp_path):
    """The same folds give the same arrays bit for bit; each package loads
    the other's ``ledger.npz``; the two reports' ``--json`` are equal."""
    r_led = _ledger_folds(RClientLedger(40, LEVELS))
    p_led = _ledger_folds(ClientLedger(40, LEVELS))
    r_sd, p_sd = r_led.state_dict(), p_led.state_dict()
    assert r_sd["meta"] == p_sd["meta"]
    for f in LEDGER_FIELDS:
        assert p_sd[f].dtype == r_sd[f].dtype
        np.testing.assert_array_equal(p_sd[f], r_sd[f], err_msg=f)
    assert p_led.snapshot() == r_led.snapshot()
    p_path = p_led.save(str(tmp_path / "port" / "ledger.npz"))
    r_path = r_led.save(str(tmp_path / "ref" / "ledger.npz"))
    for a, b in ((RClientLedger.load(p_path), p_led), (ClientLedger.load(r_path), r_led)):
        for f in LEDGER_FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    with open(tmp_path / "port" / "events.jsonl", "w") as f:
        f.write(json.dumps({"v": 1, "t": 0.0, "name": "watchdog", "cat": "obs", "ph": "i",
                            "args": {"kind": "nonfinite", "epoch": 3}}) + "\n")
    outs = []
    for main in (R_report.main, P_report.main):
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(tmp_path / "port"), "--json"]) == 0
        outs.append(json.loads(buf.getvalue()))
    assert outs[0] == outs[1] and outs[1]["events"]["watchdog_trips"]


def test_trace_events_pass_reference_schema(tmp_path):
    """The port's recorder, fed by a ``PhaseTimer`` and spans: every
    ``events.jsonl`` line passes the reference's ``validate_event``;
    ``trace.json`` loads with one Chrome event a line."""
    rec = TraceRecorder(str(tmp_path / "t"))
    timer = PhaseTimer()
    timer.trace = rec
    with timer.phase("dispatch"):
        pass
    with rec.span("superstep", args={"epoch0": 1, "k": 2}):
        rec.instant("probes", cat="obs", args={"epoch": 1, "nonfinite": 0})
    rec.sync()
    rec.instant("watchdog", cat="obs", args={"kind": "nonfinite"})
    path = rec.close()
    assert rec.close() == path
    trace = json.load(open(path))
    lines = [json.loads(line) for line in open(rec.events_path)]
    assert len(lines) == len(trace["traceEvents"]) == 4
    for line in lines:
        assert r_validate_event(line) == line
    assert lines[-1]["name"] == "watchdog"
    assert timer.calls == {"dispatch": 1} and set(timer.totals) == {"dispatch"}


def _raises(fn, cfg):
    try:
        fn(cfg)
    except ValueError as e:
        return str(e)
    return None


BAD_TELEMETRY = [
    {"telemetry": "sometimes"}, {"telemetry": "histogram"},
    {"watchdog": {"action": "warn"}},
    {"telemetry": "on", "watchdog": {"spike_factor": 0.5}},
    {"telemetry": "on", "watchdog": {"spike_factor": True}},
    {"telemetry": "on", "watchdog": {"limit": 1}},
    {"telemetry": "on", "watchdog": {"action": "explode"}},
    {"telemetry": "on", "watchdog": {"window": 1}},
    {"telemetry": "on", "watchdog": {"max_retries": 0}},
    {"telemetry": "on", "watchdog": {"backoff": -1.0}},
    {"telemetry": "off", "trace_dir": 3},
    {"telemetry": "on", "strategy": "sliced"},
    {"telemetry": "hist", "strategy": "grouped"},
    {"telemetry": "on", "strategy": "grouped", "superstep_rounds": 1},
]
BAD_QUARANTINE = [{"quarantine": q} for q in ("loud", {"max_norm": -1.0}, {"max_norm": True},
                                               {"bogus": 1}, 7)] \
    + [{"quarantine": "on", "strategy": "sliced"}]
BAD_POISON = [{"chaos_poison": p} for p in ([], [[1]], [[1, 2, 3]], [[-1, 0]], [[1, -2]],
                                            [[1.5, 0]], [[True, 0]], "3,1")] \
    + [{"chaos_poison": [[1, 2]], "strategy": "sliced"}]
BAD_LEDGER = [{"ledger": "sometimes"}, {"ledger": "on", "strategy": "sliced"},
              {"ledger": "on", "data_placement": "sharded"}]


@pytest.mark.parametrize("case", range(len(BAD_TELEMETRY + BAD_QUARANTINE + BAD_POISON
                                           + BAD_LEDGER)))
def test_config_refusals_carry_reference_messages(case):
    """Each malformed or conflicting knob refused by both validators with
    the same message."""
    groups = [(BAD_TELEMETRY, R_obs.resolve_telemetry_cfg, P_obs.resolve_telemetry_cfg),
              (BAD_QUARANTINE, R_obs.resolve_quarantine_cfg, P_obs.resolve_quarantine_cfg),
              (BAD_POISON, r_resolve_poison, p_resolve_poison),
              (BAD_LEDGER, R_obs.resolve_ledger_cfg, P_obs.resolve_ledger_cfg)]
    for cases, ref_fn, port_fn in groups:
        if case < len(cases):
            cfg = cases[case]
            ref, got = _raises(ref_fn, cfg), _raises(port_fn, cfg)
            assert ref is not None and got == ref, cfg
            return
        case -= len(cases)


def test_config_accepts_what_the_reference_accepts():
    """The accepted specs resolve to the same knobs; the stream store and the
    superstep let grouped probe; ``process_control`` refuses with the
    validators' messages."""
    for cfg in ({}, {"telemetry": "on"}, {"telemetry": "hist"},
                {"telemetry": "on", "watchdog": {"action": "off"}},
                {"telemetry": "on", "watchdog": {"action": "rollback", "max_retries": 2,
                                                 "backoff": 0, "spike_factor": None}},
                {"telemetry": "on", "strategy": "grouped", "superstep_rounds": 2},
                {"telemetry": "on", "strategy": "grouped", "client_store": "stream"}):
        r, p = R_obs.resolve_telemetry_cfg(cfg), P_obs.resolve_telemetry_cfg(cfg)
        assert (p.probes, p.hist, p.trace_dir) == (r.probes, r.hist, r.trace_dir)
        assert (p.watchdog is None) == (r.watchdog is None)
        if p.watchdog is not None:
            assert vars(p.watchdog) == vars(r.watchdog)
    for q in ("off", None, "on", {"max_norm": 2.5}, {"max_norm": None}):
        assert vars(P_obs.resolve_quarantine_cfg({"quarantine": q})) == \
            vars(R_obs.resolve_quarantine_cfg({"quarantine": q}))
    assert P_obs.resolve_ledger_cfg({"ledger": "on"}).enabled
    assert P_obs.PROBE_FIELDS == R_obs.PROBE_FIELDS and P_obs.HIST_FIELDS == R_obs.HIST_FIELDS
    msgs = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name("1_10_0.5_iid_fix_a1-e1_bn_1_1")
        cfg.update(data_name="MNIST", model_name="conv", strategy="grouped", telemetry="on")
        msgs.append(_raises(mod.process_control, cfg))
    assert msgs[0] is not None and msgs[0] == msgs[1]
