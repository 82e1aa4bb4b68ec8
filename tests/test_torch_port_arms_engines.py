"""Experiment arms in the engines and the experiment loop of the PyTorch/CUDA port on
the CPU (``parallel/round_engine.py``, ``parallel/grouped.py``,
``entry.common.ArmsExperiment``).

Against the port itself, bit for bit:

* ``arms=1`` (the identity arm) equals the unbatched superstep -- masked
  (int8, an evaluation fused in) and grouped, vision and LM;
* arm e of an E=2 superstep (seeds ``[None, 1]``, ``lr_scales [1, 0.5]``)
  equals its solo ``arms={"count": 1, "seeds": [1], "lr_scales": [0.5]}``
  run: masked with and without the fused evaluation, grouped, the LM;
* the int8 arms' residuals ``[E, slots, total]``: restored into a fresh
  engine, the next superstep equals the uninterrupted one;
* the experiment loop: arm 0 equals ``FedExperiment``'s run, arm 1 its solo arms
  run, a run resumed from its boundary blob the uninterrupted one (params,
  residuals), each arm's exportable checkpoint its params; per-arm
  ReduceLROnPlateau; per-arm probe records under ``telemetry`` equal the
  solo runs' records.

Against the JAX package (its E=2 arms supersteps on the CPU, the
reference's per-arm draws injected -- epoch permutations at each arm's
round keys ``fold_in(arm_stream_keys(base, seeds)[e], epoch)`` and, int8,
its codec noise -- as tests/test_torch_port_masked_superstep.py does):
each port arm to the masked superstep's contract (params within 5e-5;
int8 at most 2% of entries one grid step apart, residual the same; round
sums at rtol/atol 1e-4), and the grouped arms to the grouped contract
(rtol 5e-4, atol 5e-5).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.fed.core import arm_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.entry.common import ArmsExperiment, FedExperiment
from heterofl_tpu_torch.fed.core import (arm_stream_seed, superstep_rate_schedule,
                                         superstep_user_schedule, to_width_rates)
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint
from heterofl_tpu_torch.utils.optim import superstep_lrs
from test_torch_port_grouped import _vision_data
from test_torch_port_masked_superstep import EPOCH0, USERS
from test_torch_port_masked_superstep import _cfg as masked_cfg
from test_torch_port_round import LR, _data, reference_draws
from test_torch_port_superstep import _experiment

# an LM round on the CPU repeats bit for bit only under the deterministic
# algorithms (tests/test_torch_port_superstep.py)
deterministic = thread_limit_fixture(deterministic=True)

ARMS = {"count": 2, "seeds": [None, 1], "lr_scales": [1.0, 0.5]}
SOLO1 = {"count": 1, "seeds": [1], "lr_scales": [0.5]}
ENGINES = {"masked": RoundEngine, "grouped": GroupedRoundEngine}
CASES = {
    "masked conv int8": ("conv", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "int8"),
    "grouped conv": ("conv", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped", "dense"),
    "masked transformer": ("transformer", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "dense"),
    "grouped transformer": ("transformer", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped", "dense"),
}


def _bits(what, a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    diff = float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0
    rel = diff / max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
    print(f"parity {what}: max_abs_err {diff:.3e} max_rel_err {rel:.3e}")
    assert a.shape == b.shape and torch.equal(a, b), what


def _same_out(what, out, ref):
    """Two fetched supersteps' round sums (and evaluations, probes) bit for bit."""
    rounds = out["train"] if isinstance(out, dict) else out
    r_rounds = ref["train"] if isinstance(ref, dict) else ref
    for r, (ms, r_ms) in enumerate(zip(rounds, r_rounds)):
        for name in ("loss_sum", "score_sum", "n", "rate"):
            _bits(f"{what} round {r + 1} {name}", ms[name], r_ms[name])
    for ev, r_ev in zip(out.get("eval", []) if isinstance(out, dict) else [],
                        ref.get("eval", []) if isinstance(ref, dict) else []):
        for part in ("local", "global"):
            for name, v in r_ev[part].items():
                _bits(f"{what} eval {part} {name}", ev[part][name], v)


def _schedules(exp, root, k=2, A=4):
    users = superstep_user_schedule(root, 1, k, exp.cfg["num_users"], A, "prp")
    return users, superstep_rate_schedule(root, 1, k, exp.cfg, users)


def _arms_superstep(exp, strategy, arms, roots, lrs, mask=None, eng=None):
    """The arms' superstep from the experiment's init: masked cohorts drawn
    on each arm's root, grouped ones shared (the run's)."""
    if eng is None:
        eng = ENGINES[strategy](exp.model, dict(exp.cfg, arms=arms), exp.device)
    P0 = exp.engine.flatten(exp.model.params())
    sched = [_schedules(exp, r) for r in roots] if strategy == "masked" else \
        [_schedules(exp, exp.seed)]
    users, rates = (np.stack([s[i] for s in sched]) for i in (0, 1))
    if strategy == "grouped":
        users, rates = users[0], rates[0]
    Ps, pending = eng.train_superstep(torch.stack([P0] * len(roots)), exp.seed, 1, 2,
                                      exp.train_data, users, rates, lrs, mask,
                                      exp._fused_eval() if mask else None)
    return eng, Ps, pending.fetch()


@pytest.mark.parametrize("case", list(CASES))
def test_arms1_equals_the_unbatched_superstep(case):
    """The identity arm alone: params, round sums (evaluation fused into
    the masked int8 case) and residual equal the plain superstep's."""
    model_name, control, strategy, codec = CASES[case]
    exp = _experiment(model_name, control, strategy, codec)
    lrs = superstep_lrs(exp.scheduler, 1, 2)
    mask = [False, True] if codec == "int8" else None
    users, rates = _schedules(exp, exp.seed)
    P0 = exp.engine.flatten(exp.model.params())
    P, pending = exp.engine.train_superstep(P0.clone(), exp.seed, 1, 2, exp.train_data, users,
                                            rates, lrs, mask, exp._fused_eval() if mask else None)
    ref = pending.fetch()
    eng, Ps, out = _arms_superstep(exp, strategy, 1, [exp.seed], lrs, mask)
    assert Ps.shape == (1, P.numel()) and len(out["arms"]) == 1
    _bits(f"arms=1 {case}: params", Ps[0], P)
    _same_out(f"arms=1 {case}", out["arms"][0], ref)
    if codec == "int8":
        _bits(f"arms=1 {case}: residual", eng.wire_resid_host()[0],
              exp.engine.wire_resid_host())


SOLO_CASES = {
    "masked conv eval": ("conv", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "dense", True),
    "masked conv": ("conv", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "dense", False),
    "grouped conv eval": ("conv", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped", "dense", True),
    "masked transformer": ("transformer", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "dense",
                           False),
    "grouped transformer": ("transformer", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped",
                            "dense", True),
}


@pytest.mark.parametrize("case", list(SOLO_CASES))
def test_arm_equals_its_solo_run(case):
    """Arm 1 of the E=2 superstep equals the solo arms run of its seed and
    scale; arm 0 (the identity arm) differs from it."""
    model_name, control, strategy, codec, with_eval = SOLO_CASES[case]
    exp = _experiment(model_name, control, strategy, codec)
    lrs = superstep_lrs(exp.scheduler, 1, 2)
    mask = [False, True] if with_eval else None
    root1 = arm_stream_seed(exp.seed, 1)
    _, Ps, out = _arms_superstep(exp, strategy, ARMS, [exp.seed, root1], lrs, mask)
    _, Ps1, out1 = _arms_superstep(exp, strategy, SOLO1, [root1], lrs, mask)
    _bits(f"arm 1 == solo {case}: params", Ps[1], Ps1[0])
    _same_out(f"arm 1 == solo {case}", out["arms"][1], out1["arms"][0])
    assert not torch.equal(Ps[0], Ps[1])
    if with_eval:
        assert out["arms"][1]["eval"][0]["epoch"] == 2


def test_codec_arms_residual_round_trip():
    """The int8 arms' residuals ``[E, slots, total]``: a fresh engine given
    the host copy trains the next superstep as the engine that made them."""
    exp = _experiment("conv", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "int8")
    lrs = superstep_lrs(exp.scheduler, 1, 2)
    roots = [exp.seed, arm_stream_seed(exp.seed, 1)]
    eng, Ps, _ = _arms_superstep(exp, "masked", ARMS, roots, lrs)
    resid = eng.wire_resid_host()
    assert resid.shape == (2, 1, eng.spec.total) and np.any(resid[0] != resid[1])
    fresh = RoundEngine(exp.model, dict(exp.cfg, arms=ARMS), exp.device)
    fresh.set_wire_resid(resid)
    sched = [_schedules(exp, r) for r in roots]
    users, rates = np.stack([s[0] for s in sched]), np.stack([s[1] for s in sched])
    outs = [e.train_superstep(Ps.clone(), exp.seed, 3, 2, exp.train_data, users, rates, lrs)
            for e in (eng, fresh)]
    _bits("int8 arms: after a restored residual, params", outs[1][0], outs[0][0])
    _bits("int8 arms: after a restored residual, residual", fresh.wire_resid_host(),
          eng.wire_resid_host())
    with pytest.raises(ValueError, match="wire residual of shape"):
        fresh.set_wire_resid(resid[0])


# --- against the reference ----------------------------------------------------------------------

def _arm_lrs():
    return np.asarray([np.float32(LR) * np.float32(s) for s in ARMS["lr_scales"]], np.float32)


@pytest.fixture(scope="module", params=["dense", "int8"])
def masked_arms(request):
    """The reference's and the port's E=2 masked arms supersteps from the
    reference's init, the users shared, each arm's draws (and int8 noise)
    at its own round keys.  No evaluation is fused in: each arm's is its
    solo run's bit for bit (``test_arm_equals_its_solo_run``), and the
    solo fused evaluation is held against the reference's in
    tests/test_torch_port_masked_superstep.py; the reference's arms
    evaluation would double its compile time here."""
    codec = request.param
    rcfg, pcfg = masked_cfg(RC, codec), masked_cfg(PC, codec)
    rcfg["arms"] = pcfg["arms"] = ARMS
    arrays = _data()
    k, A = USERS.shape
    E_loc, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    rmodel = r_make_model(rcfg)
    params = {n: np.asarray(v) for n, v in rmodel.init(jax.random.key(0)).items()}
    base_key = jax.random.key(7)
    reng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
    lr_vec = _arm_lrs()
    r_new, pend = reng.train_superstep(
        {n: jnp.stack([jnp.asarray(v)] * 2) for n, v in params.items()}, base_key, EPOCH0, k,
        tuple(jnp.asarray(a) for a in arrays), user_schedule=USERS, lr=lr_vec)
    r_out = pend.fetch()
    rspec = RFlatSpec({n: v.shape for n, v in params.items()})
    r_flat = [np.asarray(rspec.flatten({n: jnp.asarray(v[e]) for n, v in r_new.items()}))
              for e in range(2)]
    r_resid = None if codec == "dense" else \
        np.asarray(reng.wire_resid_host()).reshape(2, -1, rspec.total)[:, 0]

    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params))
    eng = RoundEngine(model, pcfg, torch.device("cpu"))
    solo = RoundEngine(model, dict(pcfg, arms=None), torch.device("cpu"))
    spec = eng.spec

    def to_port(ref_flat):
        leaves = {n: np.asarray(v) for n, v in rspec.unflatten(jnp.asarray(ref_flat)).items()}
        return spec.flatten(params_from_jax(leaves))

    akeys = arm_stream_keys(base_key, ARMS["seeds"])
    keys = [[jax.random.fold_in(akeys[e], EPOCH0 + r) for r in range(k)] for e in range(2)]
    draws = [[reference_draws(key, USERS[r], E_loc, N)[0] for r, key in enumerate(ks)]
             for ks in keys]
    noise = None if codec == "dense" else [[to_port(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0), (rspec.total,),
        jnp.float32))) for key in ks] for ks in keys]
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    rates = eng.fix_rates[USERS]
    P0 = eng.flatten(model.params())
    out = {"codec": codec, "A": A}
    if codec == "int8":  # each arm's round 1 alone: the params that size round 2's grid step
        counts = torch.stack([eng.count_mask_flat(float(wr), data[3][u]) for u, wr in
                              zip(USERS[1], to_width_rates(rates[1], pcfg))]).sum(0)
        out["step"] = []
        for e in range(2):
            P1, _ = solo.train_round(P0.clone(), float(lr_vec[e]), USERS[0], data, 0,
                                     epoch_perms=draws[e][0], codec_noise=noise[e][0])
            solo.reset_carries()
            s = solo.codec.scale_flat(P1, A)
            out["step"].append((torch.where(counts > 0, s / counts.clamp_min(1), 0.0), s))
    Ps, pending = eng.train_superstep(
        torch.stack([P0, P0]), 0, EPOCH0, k, data, USERS, rates,
        np.repeat(lr_vec[:, None], k, 1), epoch_perms=draws, codec_noise=noise)
    out["ref"] = ([to_port(f) for f in r_flat], r_out,
                  None if r_resid is None else [to_port(r) for r in r_resid])
    out["port"] = (Ps, pending.fetch(), eng.wire_resid_host())
    return out


@pytest.mark.parametrize("arm", [0, 1])
def test_masked_arms_match_reference(masked_arms, arm):
    """Arm e's params (int8: and residual) after the two rounds and its
    round sums against the reference's arm e."""
    r_Ps, r_out, r_resid = masked_arms["ref"]
    Ps, out, resid = masked_arms["port"]
    case = f"masked {masked_arms['codec']} arms superstep, arm {arm}"
    if masked_arms["codec"] == "dense":
        assert resid is None
        assert_close(f"{case}: params after 2 rounds", Ps[arm], r_Ps[arm], rtol=0, atol=5e-5)
    else:
        step, s = masked_arms["step"][arm]
        assert_grid_close(f"{case}: params after 2 rounds", Ps[arm], r_Ps[arm], step,
                          atol=5e-5, max_share=0.02)
        assert_grid_close(f"{case}: residual", resid[arm, 0], r_resid[arm], s,
                          atol=5e-5 * masked_arms["A"], max_share=0.02)
    a, r_a = out["arms"][arm], r_out["arms"][arm]
    rounds = a["train"] if isinstance(a, dict) else a
    r_rounds = r_a["train"] if isinstance(r_a, dict) else r_a
    for r, (ms, r_ms) in enumerate(zip(rounds, r_rounds), start=1):
        assert_close(f"{case} round {r}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"{case} round {r}: {name}", ms[name], r_ms[name], rtol=1e-4,
                         atol=1e-4)


G_CONTROL = "1_6_1_iid_fix_a2-c2-e2_bn_1_1"  # users 0, 1 at level a; 2, 3 at c; 4, 5 at e
G_USERS = np.array([[0, 1, 2, 4], [3, 4, 5, 0]])


def _grouped_cfg(mod):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(G_CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, strategy="grouped",
               superstep_rounds=2, arms=ARMS,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}})
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def test_grouped_arms_match_reference():
    """The grouped E=2 arms superstep (the schedule shared, each arm's
    client draws at its round keys) against the reference's: each arm's
    params at the grouped contract, its round sums at rtol/atol 1e-4, ``n``
    and rates exactly."""
    rcfg, pcfg = _grouped_cfg(RC), _grouped_cfg(PC)
    arrays = _vision_data("MNIST", 6, 360, short=(1, 45))
    k = G_USERS.shape[0]
    rates = np.asarray(rcfg["model_rate"], np.float32)[G_USERS]
    E_loc, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    params = {n: np.asarray(v) for n, v in r_make_model(rcfg).init(jax.random.key(0)).items()}
    base_key = jax.random.key(7)
    lr_vec = _arm_lrs()
    reng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
    r_new, pend = reng.train_superstep({n: jnp.stack([jnp.asarray(v)] * 2)
                                        for n, v in params.items()}, base_key, EPOCH0, k,
                                       G_USERS, rates, tuple(jnp.asarray(a) for a in arrays),
                                       lr=lr_vec)
    r_out = pend.fetch()
    rspec = RFlatSpec({n: v.shape for n, v in params.items()})
    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params, perms))
    eng = GroupedRoundEngine(model, pcfg, torch.device("cpu"))
    akeys = arm_stream_keys(base_key, ARMS["seeds"])
    draws = [[reference_draws(jax.random.fold_in(akeys[e], EPOCH0 + r), G_USERS[r], E_loc,
                              N)[0] for r in range(k)] for e in range(2)]
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    P0 = eng.flatten(model.params())
    Ps, pending = eng.train_superstep(torch.stack([P0, P0]), 0, EPOCH0, k, data, G_USERS, rates,
                                      np.repeat(lr_vec[:, None], k, 1), epoch_perms=draws)
    out = pending.fetch()
    for e in range(2):
        leaves = {n: np.asarray(v[e]) for n, v in r_new.items()}
        r_P = eng.spec.flatten(params_from_jax(leaves, perms))
        assert rspec.total == eng.spec.total
        assert_close(f"grouped arms superstep, arm {e}: params after 2 rounds", Ps[e], r_P,
                     rtol=5e-4, atol=5e-5)
        for r, (ms, r_ms) in enumerate(zip(out["arms"][e], r_out["arms"][e]), start=1):
            assert_close(f"grouped arms arm {e} round {r}: n", ms["n"], r_ms["n"], rtol=0,
                         atol=0)
            for name in ("loss_sum", "score_sum"):
                assert_close(f"grouped arms arm {e} round {r}: {name}", ms[name], r_ms[name],
                             rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(ms["rate"], np.asarray(r_ms["rate"]))


# --- the experiment loop ------------------------------------------------------------------------

def _run_cfg(out, rounds=4, **over):
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
    cfg.update({"data_name": "MNIST", "model_name": "conv", "synthetic": True, "device": "cpu",
                "synthetic_sizes": {"train": 80, "test": 40}, "output_dir": str(out),
                "superstep_rounds": 2, "eval_interval": 2,
                "override": {"num_epochs": {"global": rounds, "local": 1},
                             "conv": {"hidden_size": [4, 8]}}, **over})
    return PC.process_control(cfg)


def _log(out, tag):
    with open(os.path.join(str(out), "runs", f"train_{tag}", "log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("strategy,codec", [("masked", "int8"), ("grouped", "dense")])
def test_loop_arms_equal_unbatched_solo_and_resumed(tmp_path, strategy, codec):
    """``ArmsExperiment`` end to end: arm 0 equals ``FedExperiment``'s run,
    arm 1 its solo arms run (params, the int8 residual, the logged round
    losses); two rounds, then two more resumed from the multiplexed blob,
    equal four uninterrupted; each arm's checkpoint holds its params."""
    kw = {"strategy": strategy, "wire_codec": codec}
    plain = FedExperiment(_run_cfg(tmp_path / "plain", **kw), 0).run()
    exp = ArmsExperiment(_run_cfg(tmp_path / "arms", arms=ARMS, **kw), 0)
    res = exp.run()
    solo = ArmsExperiment(_run_cfg(tmp_path / "solo", arms=SOLO1, **kw), 0).run()
    for name, v in plain["params"].items():
        _bits(f"loop {strategy} arm 0 == plain: {name}", res["params"][0][name], v)
        _bits(f"loop {strategy} arm 1 == solo: {name}", res["params"][1][name],
              solo["params"][0][name])
    assert [r["loss"] for r in res["history"][0]] == [r["loss"] for r in plain["history"]]
    assert [r["users"] for r in res["history"][1]] == [r["users"] for r in solo["history"][0]]
    assert [r["lr"] for r in res["history"][1]] == [np.float32(0.01) * np.float32(0.5)] * 4
    if codec == "int8":
        _bits(f"loop {strategy} arm 1 == solo: residual", res["wire_resid"][1],
              solo["wire_resid"][0])
    ArmsExperiment(_run_cfg(tmp_path / "cut", rounds=2, arms=ARMS, **kw), 0).run()
    resumed = ArmsExperiment(_run_cfg(tmp_path / "cut", arms=ARMS, resume_mode=1, **kw), 0).run()
    for e in range(2):
        for name, v in res["params"][e].items():
            _bits(f"loop {strategy} arms resumed, arm {e}: {name}", resumed["params"][e][name],
                  v)
    assert [r["epoch"] for r in resumed["history"][1]] == [3, 4]
    if codec == "int8":
        _bits(f"loop {strategy} arms resumed: residuals", resumed["wire_resid"],
              res["wire_resid"])
    tag = exp._arms_tag()
    blob = load_checkpoint(checkpoint_path(str(tmp_path / "arms"), f"{tag}_a1"))
    assert blob["arm"] == 1 and blob["arm_seed"] == 1 and blob["epoch"] == 5
    one = exp.engine.flatten(params_from_jax(blob["params"], exp.perms))
    _bits(f"loop {strategy} arm 1's exportable checkpoint", one,
          exp.engine.flatten(res["params"][1]))
    log = _log(tmp_path / "arms", tag)
    assert sorted({(r["arm"], r["epoch"]) for r in log if r.get("event") == "train"}) == \
        [(e, ep) for e in range(2) for ep in range(1, 5)]
    assert {(r["arm"], r["epoch"]) for r in log if r.get("event") == "eval"} == \
        {(e, ep) for e in range(2) for ep in (2, 4)}


def test_loop_per_arm_plateau(tmp_path):
    """ReduceLROnPlateau an arm: each arm's learning rates follow its own
    evaluations, as its solo run's; arm 1 at its scale."""
    over = {"scheduler_name": "ReduceLROnPlateau", "factor": 0.5, "patience": 0,
            "threshold": 10.0, "min_lr": 1e-6}
    kw = {"override": {"num_epochs": {"global": 6, "local": 1}, "conv": {"hidden_size": [4, 8]},
                       **over}}
    res = ArmsExperiment(_run_cfg(tmp_path / "arms", arms=ARMS, **kw), 0).run()
    solo = ArmsExperiment(_run_cfg(tmp_path / "solo", arms=SOLO1, **kw), 0).run()
    lrs = [[r["lr"] for r in h] for h in res["history"]]
    assert lrs[1] == [r["lr"] for r in solo["history"][0]]
    assert lrs[0][:2] == [np.float32(0.01)] * 2 and lrs[0][2] < lrs[0][0]  # stepped down
    assert lrs[1][0] == np.float32(0.01) * np.float32(0.5)
    for name, v in solo["params"][0].items():
        _bits(f"loop plateau arm 1 == solo: {name}", res["params"][1][name], v)


def test_loop_per_arm_probes(tmp_path):
    """Masked arms under ``telemetry='on'`` and the quarantine gate: each
    arm's probe records carry ``arm`` and equal its solo run's (arm 0:
    the plain run's ``obs`` probe records)."""
    kw = {"telemetry": "on", "quarantine": "on"}
    plain = FedExperiment(_run_cfg(tmp_path / "plain", **kw), 0)
    plain.run()
    exp = ArmsExperiment(_run_cfg(tmp_path / "arms", arms=ARMS, **kw), 0)
    exp.run()
    solo = ArmsExperiment(_run_cfg(tmp_path / "solo", arms=SOLO1, **kw), 0)
    solo.run()

    def probes(out, tag, arm=None):
        recs = [r for r in _log(out, tag) if r.get("event") == "probes"
                and (arm is None or r.get("arm") == arm)]
        return [{k: v for k, v in r.items() if k not in ("t", "arm", "tag")} for r in recs]

    arms0 = probes(tmp_path / "arms", exp._arms_tag(), 0)
    assert len(arms0) == 4 and arms0 == probes(tmp_path / "plain", plain.tag)
    assert probes(tmp_path / "arms", exp._arms_tag(), 1) == \
        probes(tmp_path / "solo", solo._arms_tag(), 0)
    assert "update_norm" in arms0[0] and "quarantined" in arms0[0]
