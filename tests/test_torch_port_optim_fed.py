"""RMSprop, Adam and Adamax in the port's federated engines, against the JAX
package on the CPU.

The reference keeps the per-leaf chain for every optimizer but SGD
(``resolve_fused_mode`` -> None, heterofl_tpu/ops/fused_update.py:65-79): a
fresh ``_opt_init`` state per client (round_engine.py:593-594), the update
after the clip, and the whole state -- slots and the ``OptState.step``
counter Adam's bias correction reads -- gated by ``has`` (:627-633).  The
port runs the same update over flat buffers (``utils.optim.FlatOptimizer``).
Held here:

* ``resolve_fused_mode`` and a non-SGD round, twins of the reference's
  ``tests/test_fused_update.py:186-197`` and ``:464-474``;
* the flat update equal to ``make_optimizer``'s per-leaf update bit for bit,
  for all four optimizers, a ``has``-false step and a grouped row past its
  budget leaving params, slots and counter unchanged;
* masked K=1 rounds against ``RoundEngine.train_round`` (conv and LM, each
  optimizer), a grouped round against ``GroupedRoundEngine.train_round``
  and the sliced twin against the grouped round under Adam, the reference's
  draws handed in, under the adaptive rounds' contract
  (:func:`_assert_round`);
* under SGD with ``fused_update`` off, the masked conv and LM rounds and
  the grouped round equal bit for bit the rounds whose step is the
  per-leaf SGD chain the engines ran before the flat optimizer;
* under Adam, the superstep against its K=1 rounds and arm e against its
  solo run, bit for bit;
* under Adam, the masked and the grouped round at ``(1, 2)`` (two gloo ranks,
  one spawn) against one rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import resolve_fused_mode as r_resolve
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.entry.common import FedExperiment
from heterofl_tpu_torch.fed.core import arm_stream_seed, round_seed
from heterofl_tpu_torch.fed.sliced import SlicedFederation
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.ops.fused_update import FlatSpec, resolve_fused_mode
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.parallel import mesh as M
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from heterofl_tpu_torch.utils.optim import (SLOTS, FlatOptimizer, clip_by_global_norm,
                                            make_optimizer, superstep_lrs)

from test_torch_port_arms_engines import ARMS, SOLO1, _arms_superstep, _same_out, _schedules
from test_torch_port_grouped import _reference_grouped, _vision_data
from test_torch_port_grouped import _cfg as grouped_cfg
from test_torch_port_lm import BPTT, SMALL as LM_SMALL, _round_data, draws_of
from test_torch_port_lm import _cfg as lm_cfg
from test_torch_port_round import _data, reference_draws
from test_torch_port_round import _cfg as round_cfg
from test_torch_port_superstep import DATA, SMALL, _bits
from torch_port_ranks import _round_job, grouped_job, run_ranks

# every round here repeats bit for bit only under the deterministic
# algorithms (an LM round on the CPU does not otherwise)
deterministic = thread_limit_fixture(deterministic=True)

OPTIMIZERS = ["RMSprop", "Adam", "Adamax"]
LR = 1e-3  # an adaptive optimizer's rate (the reference's Adam default is 3e-4)
TOL_ROUND = 5e-5  # params atol of a round against the reference (the rounds' contract)
CHAOS = 2.0  # RMSprop: times the reference's own move under a 1e-6 change of its init
MOVE = 1.25  # the zero-gradient leaves' move from the init: times the reference's, either way
# the leaves whose gradient is zero in exact arithmetic: a conv bias feeding
# a train-mode BN (which subtracts it again), the attention's key bias
# (softmax is blind to a shift a query row)
ZERO_GRAD = (".conv.b", ".mha.k.b")
GROUPED = "1_4_1_iid_fix_a2-e2_bn_1_1"  # two clients at level a, two at e


def _with(cfg, name):
    return dict(cfg, optimizer_name=name)


# --- the mode and the flat update ---------------------------------------------------------

@pytest.mark.parametrize("name", ["SGD"] + OPTIMIZERS)
@pytest.mark.parametrize("fused", [True, False, "cuda", "turbo"])
def test_resolve_fused_mode(name, fused):
    """Twin of the reference's ``test_resolve_fused_mode``: every optimizer
    but SGD resolves to None before ``fused_update`` is read (the
    reference's answer too); SGD resolves as before -- ``True`` to the
    plain version on the CPU, ``False`` to None, ``"cuda"`` raising off
    CUDA, anything else refused."""
    cfg, cpu = {"fused_update": fused, "optimizer_name": name}, torch.device("cpu")
    if name != "SGD":
        assert resolve_fused_mode(cfg, cpu) is None
        assert r_resolve(cfg) is None
    elif fused is True:
        assert resolve_fused_mode(cfg, cpu) == "plain"
    elif fused is False:
        assert resolve_fused_mode(cfg, cpu) is None and r_resolve(cfg) is None
    elif fused == "cuda":
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_fused_mode(cfg, cpu)
    else:
        with pytest.raises(ValueError, match="fused_update"):
            resolve_fused_mode(cfg, cpu)
        with pytest.raises(ValueError, match="fused_update"):
            r_resolve(cfg)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_non_sgd_optimizer_keeps_reference_chain(name):
    """Twin of the reference's test: a non-SGD optimizer keeps the unfused
    chain (fused mode None, whatever ``fused_update`` says) and the round
    runs, its sums finite and its params moved."""
    cfg = _with(round_cfg(PC), name)
    model = make_model(cfg)
    eng = RoundEngine(model, cfg, torch.device("cpu"))
    assert eng.fused_mode is None and eng.opt.name == name
    data = tuple(torch.from_numpy(a) for a in _data())
    P = eng.flatten(model.params())
    new, ms = eng.train_round(P, LR, [0, 2], data, round_seed=1)
    assert np.isfinite(np.asarray(ms["loss_sum"])).all()
    assert not torch.equal(new, P)


SHAPES = {"a.w": (4, 3), "a.b": (3,), "conv": (2, 3, 3, 3), "z": (5,)}


def _leaves(rng):
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in SHAPES.items()}


def _per_leaf_state_flat(spec, name, st):
    """``make_optimizer``'s state as flat slots (the flat state's layout)."""
    if name == "SGD":
        return {"buf": spec.flatten(st["slots"])}
    return {s: spec.flatten(st["slots"][s]) for s in SLOTS[name]}


@pytest.mark.parametrize("name", ["SGD"] + OPTIMIZERS)
def test_flat_update_equals_per_leaf(name):
    """Six steps over a dict of leaves, the fourth with ``has`` false: the
    flat update (params, slots and the device counter) equals
    ``make_optimizer``'s per-leaf update bit for bit; the gated step leaves
    params, slots and counter as they were."""
    cfg = {"optimizer_name": name, "momentum": 0.9, "weight_decay": 5e-4}
    rng = np.random.default_rng(3)
    params = _leaves(rng)
    spec = FlatSpec.of(params)
    init, update = make_optimizer(cfg)
    opt = FlatOptimizer(cfg)
    p, st = dict(params), init(params)
    pf = spec.flatten(params)
    sf = opt.init(pf)
    assert ("step" in sf) == (name in ("Adam", "Adamax"))
    lr = torch.tensor(0.01)
    for step in range(6):
        g = _leaves(rng)
        has = step != 3
        before = (pf.clone(), {k: v.clone() for k, v in sf.items()})
        opt.update_(pf, spec.flatten(g), sf, lr, torch.tensor(has))
        if not has:
            assert torch.equal(pf, before[0])
            for k, v in sf.items():
                assert torch.equal(v, before[1][k]), k
            continue
        p, st = update(p, g, st, lr)
        _bits(f"flat {name}: params, step {step}", pf, spec.flatten(p))
        for s, v in _per_leaf_state_flat(spec, name, st).items():
            _bits(f"flat {name}: slot {s}, step {step}", sf[s], v)
        if "step" in sf:
            assert sf["step"].dtype == torch.int32 and int(sf["step"]) == st["step"]


@pytest.mark.parametrize("name", ["SGD"] + OPTIMIZERS)
def test_flat_update_rows(name):
    """``[G, ld]`` rows (a grouped level, padded past n) in one pass: each
    row with budget left equals the one-client flat update bit for bit;
    the row whose budget is 0 (``lim`` 0: ``has`` false every step) keeps
    its params, slots and counter; the pad columns stay zero."""
    cfg = {"optimizer_name": name, "momentum": 0.9, "weight_decay": 5e-4}
    rng = np.random.default_rng(4)
    G, n, ld = 3, 41, 44
    opt = FlatOptimizer(cfg)
    p = torch.zeros(G, ld)
    p[:, :n] = torch.from_numpy(rng.normal(size=(G, n)).astype(np.float32))
    st = opt.init(p)
    assert ("step" not in st) or st["step"].shape == (G,)
    ones = [(p[i, :n].clone(), opt.init(p[i, :n])) for i in range(G)]
    p0 = p.clone()
    lim = torch.tensor([4, 0, 2])
    lr = torch.tensor(0.02)
    for t in range(4):
        g = torch.from_numpy(rng.normal(size=(G, n)).astype(np.float32))
        live = lim > t
        opt.update_(p[:, :n], g, opt.rows(st, n), lr, live)
        for i in range(G):
            if bool(live[i]):
                opt.update_(ones[i][0], g[i], ones[i][1], lr, torch.tensor(True))
    for i in range(G):
        _bits(f"rows {name}: row {i} params", p[i, :n], ones[i][0])
        for s in opt.slots:
            _bits(f"rows {name}: row {i} slot {s}", st[s][i, :n], ones[i][1][s])
        if "step" in st:
            assert int(st["step"][i]) == int(ones[i][1]["step"]) == min(4, int(lim[i]))
    assert torch.equal(p[1], p0[1])
    for s in opt.slots:
        assert not st[s][1].any() and not st[s][:, n:].any()
    assert not p[:, n:].any()


# --- SGD as before --------------------------------------------------------------------------

def _leaf_sgd(eng, p, buf, grads, mask, n_glob, lr, has) -> None:
    """The per-leaf SGD chain the engines' unfused step ran before the flat
    optimizer (ref round_engine.py:622-634): mean-normalise, width mask,
    global-norm clip, torch's SGD, the ``has`` gate -- in place on leaf
    views of the flat ``p`` and ``buf``."""
    spec = eng.spec
    pt, bt, mt = spec.unflatten(p), spec.unflatten(buf), spec.unflatten(mask)
    denom = n_glob.clamp_min(1e-6)
    gm = {k: (gr / denom) * mt[k] for k, gr in zip(spec.names, grads)}
    gm, _ = clip_by_global_norm(gm, 1.0)
    for k in spec.names:  # torch SGD, written out: buf = m * buf + g + wd * p; p -= lr * buf
        new_b = eng.opt.momentum * bt[k] + gm[k] + eng.opt.weight_decay * pt[k]
        new_p = pt[k] - lr * new_b
        pt[k].copy_(torch.where(has, new_p, pt[k]))
        bt[k].copy_(torch.where(has, new_b, bt[k]))


def _leaf_step(eng):
    """``eng._step`` (one rank) on :func:`_leaf_sgd`: a masked engine's a
    client, a grouped engine's each client of a level in turn."""
    def masked(p, opt, g, grads, mask, n_glob, lr, sums=None):
        assert sums is None
        eng.local_steps += 1
        _leaf_sgd(eng, p, opt["buf"], grads, mask, n_glob, lr, n_glob > 0)

    def grouped(lv, p, opt, g, grads, n_glob, lr, live=None, sums=None):
        assert sums is None
        eng.local_steps += 1
        has = n_glob > 0 if live is None else (n_glob > 0) & live
        for i in range(p.shape[0]):
            _leaf_sgd(lv.engine, p[i], opt["buf"][i], [gr[i] for gr in grads], lv.mask,
                      n_glob[i], lr, has[i])

    return grouped if isinstance(eng, GroupedRoundEngine) else masked


SGD_CASES = {
    "masked conv": lambda: (RoundEngine, round_cfg(PC), _data(), 0.05),
    "masked LM": lambda: (RoundEngine, _lm_cfg(PC, "SGD"), _round_data(), 0.1),
    "grouped conv": lambda: (GroupedRoundEngine, grouped_cfg(PC, GROUPED, pallas=True),
                             _vision_data("MNIST", 4, 240, short=(1, 45)), 0.05),
}


@pytest.mark.parametrize("case", list(SGD_CASES))
def test_sgd_round_equals_leaf_chain(case):
    """Under SGD with ``fused_update`` off, a round equals bit for bit --
    params and sums -- the same round whose step is :func:`_leaf_sgd`, the
    per-leaf chain of the engines before the flat optimizer (momentum 0.9,
    weight decay 5e-4)."""
    engine, cfg, arrays, lr = SGD_CASES[case]()
    cfg = dict(cfg, fused_update=False, momentum=0.9, weight_decay=5e-4)
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    out = []
    for leaf in (False, True):
        model = make_model(cfg)
        eng = engine(model, cfg, torch.device("cpu"))
        assert eng.fused_mode is None and eng.opt.name == "SGD"
        if leaf:
            eng._step = _leaf_step(eng)
        out.append(eng.train_round(eng.flatten(model.params()), lr, [0, 1, 2, 3], data,
                                   round_seed=0))
    (P, ms), (P_leaf, ms_leaf) = out
    _bits(f"SGD {case}: params", P, P_leaf)
    for k in ("loss_sum", "score_sum", "n"):
        _bits(f"SGD {case}: {k}", ms[k], ms_leaf[k])


# --- masked rounds against the reference -------------------------------------------------

def _port_round(engine, pcfg, params_np, arrays, users, lr, **hooks):
    """The port's round of ``engine`` from the reference's params -> (new
    params in the reference's layout, metric sums)."""
    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params_np, perms))
    eng = engine(model, pcfg, torch.device("cpu"))
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    new, ms = eng.train_round(eng.flatten(model.params()), lr, users, data, round_seed=0,
                              **hooks)
    return params_to_jax(eng.unflatten(new), perms), ms


def _flat(tree, keys=None):
    return np.concatenate([np.asarray(tree[k]).ravel() for k in sorted(keys or tree)])


def _max_diff(a, b, keys):
    return max((float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max())
                for k in keys), default=0.0)


def _move(p, p0, keys):
    """The norm of ``p``'s move from ``p0`` over ``keys``."""
    return float(np.linalg.norm(_flat(p, keys).astype(np.float64) - _flat(p0, keys)))


def _assert_round(case, name, p0, p_new, ms, r_new, r_ms, steps, r_self=None):
    """The adaptive rounds' contract (PERF.md section 6): ``n``
    exactly and the sums rtol/atol 1e-4, as every round; the params:

    * Adam and Adamax: a leaf of :data:`ZERO_GRAD` (its gradient float
      rounding alone, which an adaptive step divides by its own size: up
      to ``lr`` a step whatever its sign) within ``lr * steps``, the bound
      of its updates, and their move from the init ``p0`` (a norm) within
      :data:`MOVE` times the reference's either way; every other leaf
      within the rounds' atol 5e-5;
    * RMSprop, whose first steps are ``10 lr`` sign steps (its square
      average starts at zero) and whose round is chaotic: each of the two
      groups of leaves within :data:`CHAOS` times the move of ``r_self``
      from the reference's round -- the reference's own round from its
      init changed by 1e-6 relative -- over that group (5e-5 at least),
      and the zero-gradient leaves' move from ``p0`` as Adam's."""
    assert sorted(p_new) == sorted(r_new)
    zero = [k for k in r_new if k.endswith(ZERO_GRAD)]
    rest = [k for k in r_new if k not in zero]
    assert zero and rest
    for what, keys, atol in (("zero-gradient leaves", zero, LR * steps),
                             ("other leaves", rest, TOL_ROUND)):
        if name == "RMSprop":
            atol = max(TOL_ROUND, CHAOS * _max_diff(r_self, r_new, keys))
        assert_close(f"{case}: {what}", _flat(p_new, keys), _flat(r_new, keys), rtol=0,
                     atol=atol)
    move, r_move = _move(p_new, p0, zero), _move(r_new, p0, zero)
    assert r_move > 0 and r_move / MOVE <= move <= r_move * MOVE, \
        f"{case}: zero-gradient leaves moved {move:.4g} from the init, the reference {r_move:.4g}"
    assert_close(f"{case}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
    for k in ("loss_sum", "score_sum"):
        assert_close(f"{case}: {k}", ms[k], r_ms[k], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ms["rate"], r_ms["rate"])


def _host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _reference(eng, params_np, data, key, users, name):
    """The reference round of ``eng`` from ``params_np`` -> (new params,
    sums), and under RMSprop also its round from the init changed by 1e-6
    relative (a fixed normal draw), on the same compiled engine."""
    def run(p):
        new, ms = eng.train_round({k: jnp.asarray(v) for k, v in p.items()}, jax.random.key(key),
                                  LR, users, tuple(jnp.asarray(a) for a in data))
        return _host(new), _host(ms)

    r_new, r_ms = run(params_np)
    r_self = None
    if name == "RMSprop":
        rng = np.random.default_rng(5)
        r_self = run({k: (v * (1 + 1e-6 * rng.standard_normal(v.shape))).astype(np.float32)
                      for k, v in params_np.items()})[0]
    return r_new, r_ms, r_self


@pytest.fixture(scope="module")
def vision_rounds():
    """The reference's masked conv round (levels a, b, c, e; user 1 with a
    half-padding and two all-padding batches) under each optimizer from
    its own init, and its epoch permutations."""
    arrays, users = _data(), np.array([0, 1, 2, 3])
    out = {}
    for name in OPTIMIZERS:
        rcfg = _with(round_cfg(RC), name)
        rmodel = r_make_model(rcfg)
        params_np = _host(rmodel.init(jax.random.key(0)))
        eng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
        out[name] = (params_np,) + _reference(eng, params_np, arrays, 3, users, name)
    perms, _ = reference_draws(jax.random.key(3), users, 2, arrays[0].shape[1])
    return arrays, users, perms, out


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_masked_conv_round_matches_reference(vision_rounds, name):
    """The masked conv round under ``name`` against the reference's, from
    its params with its epoch permutations, under the adaptive rounds'
    contract.  User 1's all-padding batches step neither its params nor its
    state (its ``n`` is its 75 real samples an epoch)."""
    arrays, users, perms, out = vision_rounds
    params_np, r_new, r_ms, r_self = out[name]
    p_new, ms = _port_round(RoundEngine, _with(round_cfg(PC), name), params_np, arrays, users,
                            LR, epoch_perms=perms)
    _assert_round(f"masked conv round ({name})", name, params_np, p_new, ms, r_new, r_ms, 2 * 10,
                  r_self)
    assert ms["n"][1].item() == 75.0 * 2


def _lm_cfg(mod, name):
    """The LM tests' small transformer (tests/test_torch_port_lm.py) at one
    layer, under ``name``."""
    return _with(lm_cfg(mod, transformer=dict(LM_SMALL["transformer"], num_layers=1)), name)


@pytest.fixture(scope="module")
def lm_rounds():
    """The reference's masked LM round (levels a, b, c, e) under each
    optimizer from its own init, and the per-(user, step) draws it used."""
    rows, lm = _round_data()
    key, users = 7, np.array([0, 1, 2, 3])
    rp, out = None, {}
    for name in OPTIMIZERS:
        rcfg = _lm_cfg(RC, name)
        rmodel = r_make_model(rcfg)
        if rp is None:
            rp = _host(jax.jit(rmodel.init)(jax.random.key(0)))
        eng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
        out[name] = _reference(eng, rp, (rows, lm), key, users, name)
    slot_keys = client_stream_keys(jax.random.key(key), jnp.asarray(users))
    cache = {}

    def lm_draws(uid, t):
        if (uid, t) not in cache:
            rng = jax.random.fold_in(slot_keys[list(users).index(uid)], 5000 + t)
            cache[uid, t] = draws_of(rng, rows.shape[1], BPTT)
        return cache[uid, t]

    return rp, rows, lm, users, lm_draws, out


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_masked_lm_round_matches_reference(lm_rounds, name):
    """The masked LM round under ``name`` against the reference's, from
    the same params with its corruption and dropout draws, under the
    adaptive rounds' contract."""
    rp, rows, lm, users, lm_draws, out = lm_rounds
    r_new, r_ms, r_self = out[name]
    p_new, ms = _port_round(RoundEngine, _lm_cfg(PC, name), rp, (rows, lm), users, LR,
                            lm_draws=lm_draws)
    steps = -(-rows.shape[2] // BPTT)  # one local epoch of windows
    _assert_round(f"masked LM round ({name})", name, rp, p_new, ms, r_new, r_ms, steps, r_self)


# --- the grouped engine and the sliced twin ----------------------------------------------

@pytest.fixture(scope="module")
def grouped_adam():
    """The reference's grouped conv round under Adam (levels a and e, two
    clients each, one with a short shard), its draws, and the port's
    grouped round of the same case."""
    rcfg = _with(grouped_cfg(RC, GROUPED), "Adam")
    arrays = _vision_data("MNIST", 4, 240, short=(1, 45))
    users = np.arange(4)
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    params_np, r_new, r_ms = _reference_grouped(rcfg, arrays, users, rates, lr=LR)
    perms, _ = reference_draws(jax.random.key(3), users, 2, arrays[0].shape[1])
    pcfg = _with(grouped_cfg(PC, GROUPED, pallas=True), "Adam")
    port = _port_round(GroupedRoundEngine, pcfg, params_np, arrays, users, LR,
                       epoch_perms=perms)
    return params_np, arrays, users, perms, pcfg, port, (r_new, r_ms)


def test_grouped_round_matches_reference(grouped_adam):
    """The grouped conv round under Adam (the batched BN's plain version;
    a level's ``[G, n]`` rows and ``[G]`` counters updated in one pass)
    against ``GroupedRoundEngine.train_round``: the rounds' contract."""
    p_new, ms = grouped_adam[5]
    r_new, r_ms = grouped_adam[6]
    _assert_round("grouped conv round (Adam)", "Adam", grouped_adam[0], p_new, ms, r_new, r_ms,
                  2 * 6)
    assert ms["n"][1].item() == 45.0 * 2


def test_sliced_twin_equals_grouped(grouped_adam):
    """The sliced twin under Adam (each client through its level's
    one-client engine) equals the grouped round at the grouped engine's
    contract, rtol 5e-4 / atol 5e-5, ``n`` exactly."""
    params_np, arrays, users, perms, pcfg, (g_new, g_ms), _ = grouped_adam
    s_new, s_ms = _port_round(SlicedFederation, pcfg, params_np, arrays, users, LR,
                              epoch_perms=perms)
    assert_close("sliced vs grouped (Adam): new global params", _flat(s_new), _flat(g_new),
                 rtol=5e-4, atol=5e-5)
    assert_close("sliced vs grouped (Adam): loss_sum", s_ms["loss_sum"], g_ms["loss_sum"],
                 rtol=1e-4, atol=1e-4)
    assert torch.equal(s_ms["n"], g_ms["n"])


# --- the superstep and the arms ------------------------------------------------------------

def _experiment(model_name, control, strategy):
    """A small experiment under Adam, staged (as
    ``test_torch_port_superstep._experiment``)."""
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name(control)
    sizes = {"train": 2000, "test": 400} if model_name == "transformer" else \
        {"train": 120, "test": 40}
    cfg.update(data_name=DATA[model_name], model_name=model_name, device="cpu", synthetic=True,
               synthetic_sizes=sizes, strategy=strategy, superstep_rounds=2, pallas_norm=True,
               sampler="prp", override=dict(SMALL, optimizer_name="Adam", lr=LR))
    exp = FedExperiment(PC.process_control(cfg), 0)
    exp.stage(*exp.make_splits())
    return exp


SUPERSTEP_CASES = {
    "masked conv": ("conv", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked"),
    "grouped conv": ("conv", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped"),
    "masked transformer": ("transformer", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked"),
}


@pytest.mark.parametrize("case", list(SUPERSTEP_CASES))
def test_superstep_equals_k1_rounds(case):
    """Under Adam, a superstep of k = 2 rounds (each client's steps on the
    captured steps' static state, zeroed for every client, the counter on
    the device) equals two K=1 rounds bit for bit: params and each round's
    sums."""
    model_name, control, strategy = SUPERSTEP_CASES[case]
    exp = _experiment(model_name, control, strategy)
    eng, k = exp.engine, 2
    assert eng.fused_mode is None and eng.opt.name == "Adam"
    users, rates = _schedules(exp, 0, k)
    lrs = superstep_lrs(exp.scheduler, 1, k)
    P0 = eng.flatten(exp.model.params())
    P, seq = P0.clone(), []
    for r in range(k):
        P, ms = eng.train_round(P, float(lrs[r]), users[r], exp.train_data, round_seed(0, 1 + r),
                                rates=rates[r])
        seq.append(ms)
    P2, pending = eng.train_superstep(P0.clone(), 0, 1, k, exp.train_data, users, rates, lrs)
    _bits(f"Adam superstep {case}: params after {k} rounds", P2, P)
    _same_out(f"Adam superstep {case}", pending.fetch(), {"train": seq})


@pytest.mark.parametrize("strategy", ["masked", "grouped"])
def test_arm_equals_its_solo_run(strategy):
    """Under Adam, arm 1 of the E=2 superstep equals the solo run of its
    seed and scale bit for bit (each arm's clients start from a fresh
    state); arm 0 differs from it."""
    control = SUPERSTEP_CASES[f"{strategy} conv"][1]
    exp = _experiment("conv", control, strategy)
    lrs = superstep_lrs(exp.scheduler, 1, 2)
    root1 = arm_stream_seed(exp.seed, 1)
    _, Ps, out = _arms_superstep(exp, strategy, ARMS, [exp.seed, root1], lrs)
    _, Ps1, out1 = _arms_superstep(exp, strategy, SOLO1, [root1], lrs)
    _bits(f"Adam arm 1 == solo {strategy}: params", Ps[1], Ps1[0])
    _same_out(f"Adam arm 1 == solo {strategy}", out["arms"][1], out1["arms"][0])
    assert not torch.equal(Ps[0], Ps[1])


# --- the data axis ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data_axis(tmp_path_factory, vision_rounds, grouped_adam):
    """Under Adam, the masked conv round and the grouped round at ``(1,
    2)``: ONE spawn of two gloo ranks running both jobs in turn; the
    one-rank runs in this process."""
    out = tmp_path_factory.mktemp("optim_data")
    arrays, users, perms, rounds = vision_rounds
    params_np = rounds["Adam"][0]
    masked = dict(kind="round", cfg=_with(round_cfg(PC), "Adam"), params=params_np, data=arrays,
                  users=users, lr=LR, epoch_perms=perms)
    g_params, g_arrays, g_users, g_perms, pcfg = grouped_adam[:5]
    grouped = dict(kind="grouped", cfg=pcfg, params=g_params, data=g_arrays, users=g_users,
                   lr=LR, epoch_perms=g_perms)
    ranks = run_ranks(dict(kind="seq", deterministic=True, n_data=2, jobs=[masked, grouped]),
                      2, str(out / "w2"))
    one = M.single_mesh(torch.device("cpu"))
    return {"masked": ([rk["results"][0] for rk in ranks],
                       _round_job(dict(masked, out_dir=str(out)), one, torch)),
            "grouped": ([rk["results"][1] for rk in ranks],
                        grouped_job(dict(grouped, out_dir=str(out)), one, torch))}


@pytest.mark.parametrize("engine", ["masked", "grouped"])
def test_data_axis_round_equals_one_rank(data_axis, engine):
    """Under Adam at ``(1, 2)`` (each data rank 5 of every batch of 10, BN
    synchronised, the gradient reduced in one all-reduce before the clip
    and the update): the ranks' params and sums equal bit for bit, and
    equal the one-rank round at the rounds' contract (params atol 5e-5,
    sums rtol/atol 1e-4, ``n`` exactly)."""
    outs, one = data_axis[engine]
    for r, o in enumerate(outs[1:], start=1):
        assert np.array_equal(o["flat"], outs[0]["flat"]), f"rank {r} params"
    assert_close(f"Adam {engine} round at (1, 2) vs one rank: params", outs[0]["flat"],
                 one["flat"], rtol=0, atol=TOL_ROUND)
    assert_close(f"Adam {engine} round at (1, 2) vs one rank: n", outs[0]["round"]["n"],
                 one["round"]["n"], rtol=0, atol=0)
    assert_close(f"Adam {engine} round at (1, 2) vs one rank: loss_sum",
                 outs[0]["round"]["loss_sum"], one["round"]["loss_sum"], rtol=1e-4, atol=1e-4)
    assert outs[0]["data_collectives"].get("all_reduce", 0) > 0
