"""The client scheduler inside the PyTorch/CUDA port's engines and its
experiment loop, against the JAX reference on the CPU (``make_mesh(1, 1)``).

The reference draws the deadline speeds, the failures and (under
``perm``) the cohort permutation from ``jax.random``, which torch does not
reproduce; each comparison hands the reference's draws to the port: its
cohorts (with ``-1`` slots), its budgets (``deadline_steps`` at each
round's key), its survivors (``bernoulli`` at ``fold_in(fold_in(key, 98),
uid)``), its epoch permutations, LM corruption and dropout draws and codec
noise.

Contracts:

* masked and grouped ``train_superstep`` (vision) with a trace that leaves
  slots unfilled, a deadline, client failures and buffered aggregation
  against the reference's ``train_superstep``: params and the staleness
  buffer at rtol 5e-4 / atol 5e-5 (the grouped engine's contract against
  masked, tests/test_grouped.py), per-round metric sums at rtol/atol 1e-4,
  ``n`` and the rates (0 for a slot that did not train) exactly;
* the masked LM's K=1 rounds (buffered: two, so the buffer lands) and the
  grouped LM's K=1 round (no buffered aggregation at K=1) against the
  reference's ``train_round``, the same contract;
* int8 with ``-1`` slots, a round of padding only included, against the
  reference's ``train_superstep`` on the grid contract of the masked int8
  test (within 5e-5 everywhere but at most 2% of entries, each at most one
  grid step apart): the grid is sized by the round's slots and the codec
  runs (and moves the residual) when no slot trains;
* superstep == K=1 rounds bit for bit under a deadline, failures and
  buffered aggregation (the reference's contract, tests/test_sched.py:
  242-430), masked vision and LM; grouped superstep == supersteps of one
  round carrying the buffer;
* the entry: a markov + deadline + buffered + failures run resumed at a
  superstep boundary equals the uninterrupted one (ref tests/test_sched.py:
  674-700), masked and grouped; K=1 == K=2 in cohorts and params; the
  checkpoint's ``sched_buf`` loads into the reference's engine and back.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.fed.core import client_stream_keys, failure_stream_key
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.sched.deadline import deadline_steps as r_deadline_steps
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import flat_from_jax, params_from_jax, params_to_jax
from heterofl_tpu_torch.entry import train_classifier_fed
from heterofl_tpu_torch.fed.core import round_seed
from heterofl_tpu_torch.fed.sliced import SlicedFederation
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from test_torch_port_grouped import _vision_data
from test_torch_port_lm import BPTT, SMALL, draws_of
from test_torch_port_lm import _cfg as lm_cfg
from test_torch_port_round import reference_draws

few_threads = thread_limit_fixture(deterministic=True)

CONTROL = "1_6_1_iid_fix_a2-c2-e2_bn_1_1"  # users 0, 1 at level a; 2, 3 at c; 4, 5 at e
LR, EPOCH0, MIN_FRAC, FAIL = 0.05, 3, 0.5, 0.3
SCENARIO = {"kind": "trace", "trace": [[1] * 6], "deadline": {"min_frac": MIN_FRAC},
            "aggregation": "buffered", "staleness": 0.5}
# [k, A]: a -1 slot sits at user 5's level (e) in the grouped engine
USERS = np.array([[0, 2, -1, 4], [3, -1, 5, 1], [1, 4, 2, -1]])
BASE_KEY = 7


def _cfg(mod, strategy, schedule=SCENARIO, fail=FAIL, codec="dense", k=3):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, strategy=strategy,
               schedule=schedule, client_failure_rate=fail, wire_codec=codec,
               error_feedback=True, superstep_rounds=k,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}})
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def reference_scenario_draws(key, users, total, E, N):
    """What the reference draws in a round at ``key`` for the slots
    ``users``: the epoch permutations (keyed by ``max(uid, 0)``), the
    deadline budgets and the survivors, in slot order."""
    ugid = np.maximum(users, 0)
    perms, _ = reference_draws(key, ugid, E, N)
    limits = np.asarray(r_deadline_steps(key, jnp.asarray(ugid), total, MIN_FRAC))
    fkey = failure_stream_key(key)
    alive = np.asarray([not bool(jax.random.bernoulli(jax.random.fold_in(fkey, int(u)), FAIL))
                        for u in ugid])
    return perms, limits, alive


def _port_engine(engine, pcfg, params):
    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params, perms))
    return engine(model, pcfg, torch.device("cpu")), perms


def _to_port(spec, rspec, perms, ref_flat):
    """Reference flat rows -> the port's flat layout."""
    return torch.from_numpy(flat_from_jax(np.asarray(ref_flat), spec.shapes, perms)) \
        if rspec.total == spec.total else None


@pytest.fixture(scope="module")
def vision():
    arrays = _vision_data("MNIST", 6, 360, short=(1, 45))
    rcfg = _cfg(RC, "masked")
    params = {n: np.asarray(v) for n, v in r_make_model(rcfg).init(jax.random.key(0)).items()}
    E, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    total = E * -(-N // rcfg["batch_size"]["train"])
    keys = [jax.random.fold_in(jax.random.key(BASE_KEY), EPOCH0 + r) for r in range(len(USERS))]
    draws = [reference_scenario_draws(key, USERS[r], total, E, N) for r, key in enumerate(keys)]
    return arrays, params, keys, draws


@pytest.fixture(scope="module", params=["masked", "grouped"])
def scenario(request, vision):
    """Both packages' supersteps of the scenario from the reference's init."""
    strategy = request.param
    arrays, params, keys, draws = vision
    k = USERS.shape[0]
    rcfg, pcfg = _cfg(RC, strategy), _cfg(PC, strategy)
    live = [(lim, al) for _, lim, al in draws]
    valid = (USERS >= 0) & np.stack([al for _, al in live])
    assert (~valid & (USERS >= 0)).any() and valid.sum() > 4, "the draw should fail some"
    rates = np.asarray(rcfg["model_rate"], np.float32)[USERS]
    rdata = tuple(jnp.asarray(a) for a in arrays)
    rparams = {n: jnp.asarray(v) for n, v in params.items()}
    base = jax.random.key(BASE_KEY)
    if strategy == "masked":
        reng = RRoundEngine(r_make_model(rcfg), rcfg, make_mesh(1, 1))
        r_new, pend = reng.train_superstep(rparams, base, EPOCH0, k, rdata, user_schedule=USERS,
                                           lr=LR)
    else:
        reng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
        r_new, pend = reng.train_superstep(rparams, base, EPOCH0, k, USERS, rates, rdata, lr=LR)
    r_rounds = pend.fetch()
    rspec = RFlatSpec({n: v.shape for n, v in params.items()})
    eng, perms = _port_engine(RoundEngine if strategy == "masked" else GroupedRoundEngine, pcfg,
                              params)
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    P, pending = eng.train_superstep(
        eng.flatten(eng.model.params()), 0, EPOCH0, k, data, USERS, rates, [LR] * k,
        epoch_perms=[d[0] for d in draws], step_limits=[lim for lim, _ in live],
        alive=[al for _, al in live])
    to_port = lambda a: _to_port(eng.spec, rspec, perms, a)  # noqa: E731
    return {"strategy": strategy, "valid": valid,
            "ref": (to_port(rspec.flatten(r_new)), r_rounds, to_port(reng.sched_buf_host())),
            "port": (P, pending.fetch(), torch.from_numpy(eng.sched_buf_host()))}


def test_scenario_superstep_params_and_buffer_match_reference(scenario):
    """Params and the staleness buffer after three rounds with unfilled
    slots, a deadline, failed clients and buffered aggregation."""
    r_P, _, r_buf = scenario["ref"]
    P, _, buf = scenario["port"]
    case = f"{scenario['strategy']} scenario superstep"
    assert_close(f"{case}: params after 3 rounds", P, r_P, rtol=5e-4, atol=5e-5)
    assert_close(f"{case}: staleness buffer", buf, r_buf, rtol=5e-4, atol=5e-5)
    assert bool((buf[1] > 0).any())


def test_scenario_superstep_metrics_match_reference(scenario):
    """Each round's per-slot sums: zero rows (and rate 0) for the padding
    and failed slots, truncated ``n`` for the rest, as the reference's."""
    _, r_rounds, _ = scenario["ref"]
    _, rounds, _ = scenario["port"]
    case = f"{scenario['strategy']} scenario superstep"
    for r, (ms, r_ms) in enumerate(zip(rounds, r_rounds), start=1):
        assert_close(f"{case} round {r}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"{case} round {r}: {name}", ms[name], r_ms[name], rtol=1e-4,
                         atol=1e-4)
        np.testing.assert_array_equal(ms["rate"], np.asarray(r_ms["rate"]))
        valid = scenario["valid"][r - 1]
        assert (ms["n"][~valid] == 0).all() and (ms["n"][valid] > 0).all()


@pytest.mark.parametrize("strategy", ["masked", "grouped"])
def test_int8_superstep_with_unfilled_slots_matches_reference(vision, strategy):
    """int8 with error feedback, round 1 with a ``-1`` slot, round 2 all
    padding: the grid is sized by the slots (masked 4; grouped 3 levels x
    4, round 2's four padding slots at level e), and the round of padding
    still runs the codec, so its residual re-encodes round 1's -- the
    params on the grid contract against round 1's step, the residual
    against the final params' step."""
    arrays, params, _, _ = vision
    users = np.array([[0, -1, 2, 4], [-1, -1, -1, -1]])
    k, A = users.shape
    rcfg = _cfg(RC, strategy, schedule=None, fail=0.0, codec="int8", k=2)
    pcfg = _cfg(PC, strategy, schedule=None, fail=0.0, codec="int8", k=2)
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    rdata = tuple(jnp.asarray(a) for a in arrays)
    base = jax.random.key(BASE_KEY)
    rparams = {n: jnp.asarray(v) for n, v in params.items()}
    if strategy == "masked":
        reng = RRoundEngine(r_make_model(rcfg), rcfg, make_mesh(1, 1))
        r_new, pend = reng.train_superstep(rparams, base, EPOCH0, k, rdata, user_schedule=users,
                                           lr=LR)
    else:
        reng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
        r_new, pend = reng.train_superstep(rparams, base, EPOCH0, k, users, rates, rdata, lr=LR)
    pend.fetch()
    rspec = RFlatSpec({n: v.shape for n, v in params.items()})
    eng, perms = _port_engine(RoundEngine if strategy == "masked" else GroupedRoundEngine, pcfg,
                              params)
    to_port = lambda a: _to_port(eng.spec, rspec, perms, a)  # noqa: E731
    keys = [jax.random.fold_in(base, EPOCH0 + r) for r in range(k)]
    E, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    draws = [reference_draws(key, np.maximum(users[r], 0), E, N)[0] for r, key in enumerate(keys)]
    noise = [to_port(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0), (rspec.total,),
        jnp.float32))[None])[0] for key in keys]
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    P0 = eng.flatten(eng.model.params())
    P, pending = eng.train_superstep(P0.clone(), 0, EPOCH0, k, data, users, rates, [LR] * k,
                                     epoch_perms=draws, codec_noise=noise)
    out = pending.fetch()
    assert (out[1]["n"] == 0).all() and (out[0]["n"][users[0] < 0] == 0).all()
    cmax = A if strategy == "masked" else eng.codec_slots(rates)
    assert cmax == (4 if strategy == "masked" else 12), cmax
    counts = torch.zeros_like(P0)
    for u, rate in zip(users[0], rates[0]):
        if u < 0:
            continue
        if strategy == "masked":
            counts += eng.count_mask_flat(float(rate), data[-1][int(u)])
        else:
            lv = eng.levels[float(rate)]
            counts.index_add_(0, lv.idx, lv.count_masks(data[-1][[int(u)]])[0])
    s0 = eng.codec.scale_flat(P0, cmax)
    step = torch.where(counts > 0, s0 / counts.clamp_min(1), 0.0)
    case = f"{strategy} int8 superstep with unfilled slots"
    assert_grid_close(f"{case}: params", P, to_port(rspec.flatten(r_new)), step, atol=5e-5,
                      max_share=0.02)
    resid, r_resid = eng.wire_resid_host(), to_port(np.asarray(reng.wire_resid_host()).reshape(
        -1, rspec.total)[:1])
    assert_grid_close(f"{case}: residual after a round of padding only", resid[0], r_resid[0],
                      eng.codec.scale_flat(P, cmax), atol=5e-5 * A, max_share=0.02)
    assert bool(np.any(resid != 0))


# --- the LM, at K=1 -------------------------------------------------------------------

LM_CONTROL = "1_4_1_iid_fix_a2-b1-c1_bn_1_1"
LM_USERS = np.array([[1, -1, 2, 3], [1, 3, -1, 0]])  # round 1: user 0 only as padding


def _lm_rows():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, size=(4, 2, 40)).astype(np.int64)
    lm = np.ones((4, 50), np.float32)
    lm[3, ::4] = 0.0
    return rows, lm


@pytest.mark.parametrize("strategy", ["masked", "grouped"])
def test_lm_scenario_rounds_match_reference(strategy):
    """The LM (dropout 0.2) with ``-1`` slots, a deadline (budgets of 2 to 3
    of its 3 windows), failures and (masked) buffered aggregation: the
    port's K=1 rounds against the reference's ``train_round``, with its
    corruption and dropout draws at each level's widths."""
    sched = dict(SCENARIO, aggregation="buffered" if strategy == "masked" else "sync",
                 trace=[[1] * 4])
    rounds = 2 if strategy == "masked" else 1
    rcfg = dict(lm_cfg(RC, LM_CONTROL), strategy=strategy, schedule=sched,
                client_failure_rate=FAIL)
    pcfg = dict(lm_cfg(PC, LM_CONTROL), strategy=strategy, schedule=sched,
                client_failure_rate=FAIL)
    rows, lm = _lm_rows()
    params = {k: np.asarray(v) for k, v in r_make_model(rcfg).init(jax.random.key(0)).items()}
    if strategy == "masked":
        reng = RRoundEngine(r_make_model(rcfg), rcfg, make_mesh(1, 1))
    else:
        reng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
    eng, perms = _port_engine(RoundEngine if strategy == "masked" else GroupedRoundEngine, pcfg,
                              params)
    t = SMALL["transformer"]
    total = -(-rows.shape[2] // BPTT)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    P = eng.flatten(eng.model.params())
    data = (torch.from_numpy(rows), torch.from_numpy(lm))
    failed = 0
    for r in range(rounds):
        users, key = LM_USERS[r], jax.random.key(11 + r)
        rates = np.asarray(rcfg["model_rate"], np.float32)[users]
        if strategy == "masked":
            rp, r_ms = reng.train_round(rp, key, LR, users, (jnp.asarray(rows), jnp.asarray(lm)))
        else:
            rp, r_ms = reng.train_round(rp, users.astype(np.int32), rates,
                                        (jnp.asarray(rows), jnp.asarray(lm)), LR, key)
        ugid = np.maximum(users, 0)
        slot_keys = client_stream_keys(key, jnp.asarray(ugid))
        limits = np.asarray(r_deadline_steps(key, jnp.asarray(ugid), total, MIN_FRAC))
        fkey = failure_stream_key(key)
        alive = np.asarray([not bool(jax.random.bernoulli(jax.random.fold_in(fkey, int(u)),
                                                           FAIL)) for u in ugid])
        failed += int((~alive & (users >= 0)).sum())
        slot = {int(u): i for i, u in enumerate(ugid)}

        def lm_draws(uid, step, rates=rates, slot=slot, slot_keys=slot_keys):
            w = 1.0 if strategy == "masked" else float(rates[slot[uid]])
            return draws_of(jax.random.fold_in(slot_keys[slot[uid]], 5000 + step), rows.shape[1],
                            BPTT, width=math.ceil(t["embedding_size"] * w),
                            ffn=math.ceil(t["hidden_size"] * w))

        P, ms = eng.train_round(P, LR, users, data, 0, lm_draws=lm_draws, step_limits=limits,
                                alive=alive)
        case = f"{strategy} LM scenario round {r + 1}"
        r_ms = {k: np.asarray(v) for k, v in r_ms.items()}
        assert_close(f"{case}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"{case}: {name}", ms[name], r_ms[name], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ms["rate"], r_ms["rate"])
    p_new = params_to_jax(eng.unflatten(P), perms)
    names = sorted(p_new)
    assert_close(f"{strategy} LM scenario: params", np.concatenate([p_new[k].ravel() for k in names]),
                 np.concatenate([np.asarray(rp[k]).ravel() for k in names]), rtol=5e-4, atol=5e-5)
    assert failed or strategy == "grouped"
    if strategy == "masked":
        rspec = RFlatSpec({n: v.shape for n, v in params.items()})
        assert_close("masked LM scenario: staleness buffer", eng.sched_buf_host(),
                     _to_port(eng.spec, rspec, perms, reng.sched_buf_host()), rtol=5e-4,
                     atol=5e-5)


# --- superstep == K=1 rounds, bit for bit ---------------------------------------------

def _bits(what, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), what
    print(f"parity {what}: max_abs_err 0 (bit for bit)")


@pytest.mark.parametrize("kind", ["masked vision", "masked LM", "grouped vision", "grouped LM"])
def test_scenario_superstep_equals_rounds_bit_for_bit(vision, kind):
    """Three rounds as one superstep == three K=1 rounds (masked) or three
    supersteps of one round (grouped, whose K=1 round has no buffer) on one
    engine: params, the staleness buffer and every round's sums bit for
    bit, with the port's own deadline, failure and cohort draws."""
    strategy, what = kind.split()
    k = USERS.shape[0]
    if what == "vision":
        arrays, params, _, _ = vision
        pcfg = _cfg(PC, strategy)
        users = USERS
    else:
        pcfg = dict(lm_cfg(PC, LM_CONTROL), strategy=strategy, client_failure_rate=FAIL,
                    schedule=dict(SCENARIO, trace=[[1] * 4]), superstep_rounds=k)
        arrays = _lm_rows()
        params = {n: np.asarray(v) for n, v in
                  r_make_model(lm_cfg(RC, LM_CONTROL)).init(jax.random.key(0)).items()}
        users = np.concatenate([LM_USERS, LM_USERS[:1]])
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    rates = np.asarray(pcfg["model_rate"], np.float32)[users]
    engine = RoundEngine if strategy == "masked" else GroupedRoundEngine
    eng, _ = _port_engine(engine, pcfg, params)
    P0 = eng.flatten(eng.model.params())
    P, pending = eng.train_superstep(P0.clone(), 5, EPOCH0, k, data, users, rates, [LR] * k)
    rounds = pending.fetch()
    seq, _ = _port_engine(engine, pcfg, params)
    Q, seq_rounds = P0.clone(), []
    for r in range(k):
        if strategy == "masked":
            Q, ms = seq.train_round(Q, LR, users[r], data, round_seed(5, EPOCH0 + r))
            seq_rounds.append({n: np.asarray(v) for n, v in ms.items()})
        else:
            Q, pend = seq.train_superstep(Q, 5, EPOCH0 + r, 1, data, users[r:r + 1],
                                          rates[r:r + 1], [LR])
            seq_rounds += pend.fetch()
    _bits(f"{kind} scenario superstep == rounds: params", P, Q)
    _bits(f"{kind} scenario superstep == rounds: staleness buffer", eng.sched_buf_host(),
          seq.sched_buf_host())
    for r, (ms, sm) in enumerate(zip(rounds, seq_rounds)):
        for name in ("loss_sum", "score_sum", "n", "rate"):
            _bits(f"{kind} round {r + 1} {name}", ms[name], sm[name])
    assert any((ms["n"] == 0).any() for ms in rounds)


def test_grouped_k1_rounds_equal_superstep_under_deadline_and_failures(vision):
    """The grouped engine's eager K=1 rounds (``local_train_level`` gating
    each row by its budget) == the superstep's replayed steps (the static
    ``lim`` buffer), bit for bit, with ``-1`` slots, a deadline and
    failures (sync aggregation: the K=1 round refuses buffered)."""
    arrays, params, _, _ = vision
    pcfg = _cfg(PC, "grouped", schedule=dict(SCENARIO, aggregation="sync"))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    users = USERS[:2]
    rates = np.asarray(pcfg["model_rate"], np.float32)[users]
    eng, _ = _port_engine(GroupedRoundEngine, pcfg, params)
    P0 = eng.flatten(eng.model.params())
    P, pending = eng.train_superstep(P0.clone(), 5, EPOCH0, 2, data, users, rates, [LR] * 2)
    rounds = pending.fetch()
    seq, _ = _port_engine(GroupedRoundEngine, pcfg, params)
    Q = P0.clone()
    for r in range(2):
        Q, ms = seq.train_round(Q, LR, users[r], data, round_seed(5, EPOCH0 + r))
        for name in ("loss_sum", "score_sum", "n", "rate"):
            _bits(f"grouped K=1 == superstep round {r + 1} {name}", np.asarray(ms[name]),
                  rounds[r][name])
    _bits("grouped K=1 rounds == superstep under a deadline: params", P, Q)
    assert any((ms["n"] == 0).any() for ms in rounds)


# --- refusals ---------------------------------------------------------------------------

def test_scenario_refusals_match_reference():
    """The grouped K=1 round refuses buffered aggregation with the
    reference's message; the sliced twin refuses a scenario (the reference's
    message) and a failure rate; the entry refuses a buffered grouped run
    at ``superstep_rounds`` 1 at configuration time."""
    rcfg, pcfg = _cfg(RC, "grouped", k=2), _cfg(PC, "grouped", k=2)
    rmodel = r_make_model(rcfg)
    with pytest.raises(ValueError, match="buffered") as ref:
        RGroupedRoundEngine(rcfg, make_mesh(1, 1)).train_round(
            rmodel.init(jax.random.key(0)), np.array([0, 1], np.int32),
            np.array([1.0, 1.0], np.float32),
            tuple(jnp.asarray(a) for a in _vision_data("MNIST", 6, 60)), LR, jax.random.key(1))
    model = make_model(pcfg)
    eng = GroupedRoundEngine(model, pcfg, torch.device("cpu"))
    with pytest.raises(ValueError) as got:
        eng.train_round(eng.flatten(model.params()), LR, [0, 1], None, 0)
    assert str(got.value) == str(ref.value)
    scfg = dict(pcfg, strategy="sliced")
    with pytest.raises(ValueError, match="sliced") as got:
        SlicedFederation(model, scfg, torch.device("cpu"))
    with pytest.raises(ValueError) as ref:
        RC.process_control(dict(RC.default_cfg(), control=RC.parse_control_name(CONTROL),
                                data_name="MNIST", model_name="conv", strategy="sliced",
                                schedule=SCENARIO))
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="client_failure_rate"):
        SlicedFederation(model, dict(pcfg, strategy="sliced", schedule=None),
                         torch.device("cpu"))
    with pytest.raises(ValueError, match="superstep_rounds<=1"):
        PC.process_control(dict(PC.default_cfg(), control=PC.parse_control_name(CONTROL),
                                data_name="MNIST", model_name="conv", strategy="grouped",
                                schedule=SCENARIO))


# --- the entry -----------------------------------------------------------------------

DRIVER_SCHEDULE = {"kind": "markov",
                   "markov": {"p_on": 0.7, "p_off": 0.4, "length": 8, "seed": 1},
                   "deadline": {"min_frac": 0.4}, "aggregation": "buffered", "staleness": 0.5}


def _argv(out, rounds, *extra):
    return ["--device", "cpu", "--output_dir", str(out), "--control_name",
            "1_8_0.5_iid_fix_a1-b1_bn_1_1", "--data_name", "MNIST", "--model_name", "conv",
            "--synthetic", "1", "--synthetic_sizes", '{"train": 80, "test": 40}',
            "--eval_interval", "2", "--schedule", json.dumps(DRIVER_SCHEDULE),
            "--client_failure_rate", "0.2",
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1},
                                      "conv": {"hidden_size": [4, 8]},
                                      "batch_size": {"train": 10, "test": 20}}), *extra]


@pytest.mark.parametrize("strategy", ["masked", "grouped"])
def test_entry_scenario_resume_equals_uninterrupted(tmp_path, strategy):
    """``train_classifier_fed --schedule '<markov + deadline + buffered>'
    --client_failure_rate 0.2 --superstep_rounds 2`` over 4 rounds, against
    2 rounds and a resumed superstep from the boundary checkpoint: the same
    cohorts (``-1`` slots and failures logged), params and staleness buffer
    bit for bit; the masked K=1 run trains the same cohorts to the same
    params."""
    more = ("--strategy", strategy, "--superstep_rounds", "2")
    (full,) = train_classifier_fed.main(_argv(tmp_path / "full", 4, *more))
    train_classifier_fed.main(_argv(tmp_path / "cut", 2, *more))
    (res,) = train_classifier_fed.main(_argv(tmp_path / "cut", 4, *more, "--resume_mode", "1"))
    hist = full["history"]
    assert [r["epoch"] for r in res["history"]] == [3, 4]
    assert [r["users"] for r in res["history"]] == [r["users"] for r in hist[2:]]
    assert any(-1 in r["users"] for r in hist) and sum(r["failed"] for r in hist) > 0
    assert all(r["filled"] == sum(u >= 0 for u in r["users"]) for r in hist)
    for k, v in full["params"].items():
        _bits(f"{strategy} entry scenario resumed: {k}", res["params"][k], v)
    _bits(f"{strategy} entry scenario resumed: staleness buffer", res["sched_buf"],
          full["sched_buf"])
    assert bool(np.any(full["sched_buf"] != 0))
    if strategy == "masked":
        (k1,) = train_classifier_fed.main(_argv(tmp_path / "k1", 4, "--strategy", strategy))
        assert [r["users"] for r in k1["history"]] == [r["users"] for r in hist]
        for k, v in full["params"].items():
            _bits(f"entry scenario K=1 == K=2: {k}", k1["params"][k], v)


def test_checkpoint_staleness_buffer_crosses_to_the_reference(tmp_path):
    """The checkpoint's ``sched_buf`` is the reference's ``[2, total]`` carry
    in its flat layout (``FlatSpec`` order, HWIO and ``[in, out]`` leaves):
    it equals the reference ``FlatSpec`` over the converted leaves of each
    row, the reference's engine takes it (``set_sched_buf``), and what it
    gives back converts to the port's buffer bit for bit."""
    from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint

    (run,) = train_classifier_fed.main(_argv(tmp_path, 2, "--superstep_rounds", "2"))
    blob = load_checkpoint(checkpoint_path(str(tmp_path),
                                           "0_MNIST_label_conv_1_8_0.5_iid_fix_a1-b1_bn_1_1"))
    buf = run["sched_buf"]
    assert blob["sched_buf"].shape == buf.shape == (2, buf.shape[1])
    cfg = PC.process_control(dict(PC.default_cfg(), control=PC.parse_control_name(
        "1_8_0.5_iid_fix_a1-b1_bn_1_1"), data_name="MNIST", model_name="conv",
        override={"conv": {"hidden_size": [4, 8]}}))
    cfg["classes_size"] = 10
    model = make_model(cfg)
    perms = model.jax_perms()
    eng = RoundEngine(model, cfg, torch.device("cpu"))
    rows = [params_to_jax(eng.unflatten(torch.from_numpy(buf[i])), perms) for i in range(2)]
    rspec = RFlatSpec({k: v.shape for k, v in rows[0].items()})
    want = np.stack([np.asarray(rspec.flatten({k: jnp.asarray(v) for k, v in r.items()}))
                     for r in rows])
    _bits("checkpoint sched_buf: the reference's flat layout", blob["sched_buf"], want)
    rcfg = RC.process_control(dict(RC.default_cfg(), control=RC.parse_control_name(
        "1_8_0.5_iid_fix_a1-b1_bn_1_1"), data_name="MNIST", model_name="conv",
        schedule={"aggregation": "buffered"}, override={"conv": {"hidden_size": [4, 8]}}))
    rcfg["classes_size"] = 10
    reng = RRoundEngine(r_make_model(rcfg), rcfg, make_mesh(1, 1))
    reng.set_sched_buf(blob["sched_buf"])
    back = flat_from_jax(np.asarray(reng.sched_buf_host()), eng.spec.shapes, perms)
    _bits("checkpoint sched_buf: reference and back", back, buf)
