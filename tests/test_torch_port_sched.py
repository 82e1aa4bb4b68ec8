"""The client scheduler of the PyTorch/CUDA port (``heterofl_tpu_torch/sched``
and its hooks in ``fed/``) against the JAX reference on the CPU: the
configuration, the availability traces and draws, the deadline budgets and
the buffered combine.

Contracts:

* ``markov_trace`` (pure numpy on both sides) bit for bit;
* ``resolve_schedule_cfg``: every configuration the reference accepts the
  port accepts with the same spec, every one it refuses the port refuses
  with the same exception and message;
* ``prp_round_users(avail)`` bit for bit at the reference's round keys
  (the reference's draw-then-filter walk), and the ``perm`` filter equal to
  the reference's on the reference's permutation;
* the deadline budgets equal the reference's ``deadline_steps`` given the
  reference's speeds (the float32 formula bit for bit); the port's own
  speeds stay in ``[ceil(min_frac * total), total]``;
* ``buffered_combine`` bit for bit (elementwise float32 on both sides);
* a ``-1`` slot takes user ``U - 1``'s rate, as the reference's ``jnp.take``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu import sched as RSched
from heterofl_tpu.fed import core as RCore
from heterofl_tpu.sched import buffer as RBuf
from heterofl_tpu.sched import deadline as RDead
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch import sched as PSched
from heterofl_tpu_torch.fed import core
from heterofl_tpu_torch.fed import sampling as S
from heterofl_tpu_torch.parallel.round_engine import cohort_rates
from heterofl_tpu_torch.sched.buffer import buffered_combine
from heterofl_tpu_torch.sched.deadline import budgets_from_speeds, deadline_steps
from heterofl_tpu_torch.testing import thread_limit_fixture
from test_torch_port_sampling import _reference_keys

few_threads = thread_limit_fixture()


# --- the trace and the spec ---------------------------------------------------------

@pytest.mark.parametrize("users,length,p_on,p_off,seed",
                         [(1, 1, 0.5, 0.2, 0), (12, 9, 0.5, 0.3, 7), (100, 64, 0.5, 0.2, 0),
                          (1000, 5, 1.0, 1.0, 3), (37, 20, 0.05, 0.9, 11)])
def test_markov_trace_matches_reference(users, length, p_on, p_off, seed):
    """The seeded on/off chain is the reference's, bit for bit."""
    got = PSched.markov_trace(users, length, p_on, p_off, seed)
    ref = RSched.markov_trace(users, length, p_on, p_off, seed)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    print(f"parity markov_trace U={users} T={length}: max_abs_err 0 (bit for bit)")


MARKOV = {"kind": "markov", "markov": {"p_on": 0.6, "p_off": 0.4, "length": 6, "seed": 3}}
SCHEDULE_CASES = [
    ({"schedule": None}, None),
    ({"schedule": {"kind": "uniform"}}, None),
    ({"schedule": {"kind": "uniform", "aggregation": "sync"}}, None),
    ({"num_users": 3, "schedule": {"kind": "trace", "trace": [[1, 0, 1], [0, 0, 0]]}}, None),
    ({"num_users": 10, "schedule": MARKOV}, None),
    ({"num_users": 10, "schedule": {"kind": "markov"}}, None),
    ({"schedule": {"deadline": {"min_frac": 0.3}}}, None),
    ({"schedule": {"aggregation": "buffered", "staleness": 1.0}}, None),
    ({"schedule": {"aggregation": "buffered"}, "wire_codec": {"1": "dense", "0.5": "dense"}},
     None),
    ({"schedule": {"aggregation": "buffered"}, "strategy": "grouped", "superstep_rounds": 2},
     None),
    ({"schedule": {"deadline": {"min_frac": 0.5}}, "strategy": "grouped"}, None),
    ({"schedule": "markov"}, "Not valid schedule"),
    ({"schedule": {"knd": "uniform"}}, "schedule keys"),
    ({"schedule": {"kind": "round-robin"}}, "schedule kind"),
    ({"schedule": {"kind": "trace"}}, "needs a 'trace'"),
    ({"schedule": {"kind": "trace", "trace": [1, 0, 1]}}, "trace shape"),
    ({"schedule": {"kind": "trace", "trace": [[2, 0], [1, 1]]}}, "0/1 only"),
    ({"num_users": 3, "schedule": {"kind": "trace", "trace": [[1, 0], [1, 1]]}}, "num_users"),
    ({"num_users": 4, "schedule": {"kind": "markov", "markov": {"p_on": 2.0}}}, "markov p_on"),
    ({"num_users": 4, "schedule": {"kind": "markov", "markov": {"p_off": 0}}}, "markov p_off"),
    ({"num_users": 4, "schedule": {"kind": "markov", "markov": {"length": 0}}}, "length"),
    ({"num_users": 4, "schedule": {"kind": "markov", "markov": {"mu": 1}}}, "markov keys"),
    ({"schedule": {"kind": "markov"}}, "needs cfg\\['num_users'\\]"),
    ({"schedule": {"kind": "uniform", "trace": [[1]]}}, "takes no trace"),
    ({"schedule": {"deadline": {"min_frac": 1.5}}}, "min_frac"),
    ({"schedule": {"deadline": {"min_frac": 1.0}}}, "min_frac"),
    ({"schedule": {"deadline": 0.5}}, "schedule deadline"),
    ({"schedule": {"aggregation": "async"}}, "aggregation"),
    ({"schedule": {"staleness": 0.0}}, "staleness"),
    ({"schedule": {"deadline": {"min_frac": 0.5}}, "strategy": "sliced"}, "sliced"),
    ({"schedule": {"aggregation": "buffered"}, "wire_codec": "int8"}, "wire_codec='int8'"),
    ({"schedule": {"aggregation": "buffered"}, "wire_codec": {"1": "int8", "0.5": "dense"},
      "strategy": "grouped", "superstep_rounds": 2}, "wire_codec="),
    ({"schedule": {"aggregation": "buffered"}, "strategy": "grouped"}, "superstep_rounds<=1"),
]


@pytest.mark.parametrize("cfg,match", SCHEDULE_CASES,
                         ids=[f"case{i}" for i in range(len(SCHEDULE_CASES))])
def test_resolve_schedule_cfg_matches_reference(cfg, match):
    """The reference's acceptances and refusals (ref tests/test_sched.py:
    116-150, 429-458, and every branch of its validator), one table: an
    accepted configuration gives the same spec, a refused one the same
    exception type and message."""
    if match is not None:
        with pytest.raises(ValueError, match=match) as ref:
            RSched.resolve_schedule_cfg(cfg)
        with pytest.raises(type(ref.value)) as got:
            PSched.resolve_schedule_cfg(cfg)
        assert str(got.value) == str(ref.value)
        return
    ref, got = RSched.resolve_schedule_cfg(cfg), PSched.resolve_schedule_cfg(cfg)
    for name in ("kind", "lockstep", "buffered", "has_deadline", "deadline_min_frac",
                 "aggregation", "staleness", "markov"):
        assert getattr(got, name) == getattr(ref, name), name
    if ref.trace is None:
        assert got.trace is None
    else:
        np.testing.assert_array_equal(got.trace, ref.trace)
        for epoch in (1, 2, 7, 64, 65):
            np.testing.assert_array_equal(got.avail_row(epoch), ref.avail_row(epoch))


def test_staleness_weight_and_the_config_path():
    """``staleness_weight`` is the reference's; ``process_control`` takes
    ``schedule`` and ``client_failure_rate`` (no longer refused as not
    ported) and refuses a bad schedule with the reference's message."""
    for alpha, s in ((0.5, 1), (1.0, 1), (0.3, 3)):
        assert PSched.staleness_weight(alpha, s) == RSched.staleness_weight(alpha, s)
    cfg = PC.default_cfg()
    cfg.update(control=PC.parse_control_name("1_10_0.5_iid_fix_a1-e1_bn_1_1"), data_name="MNIST",
               model_name="conv", client_failure_rate=0.25, schedule=MARKOV)
    assert "schedule" not in PC.UNPORTED and "client_failure_rate" not in PC.UNPORTED
    out = PC.process_control(cfg)
    assert out["schedule"] == MARKOV and out["client_failure_rate"] == 0.25
    bad = dict(cfg, schedule={"kind": "trace", "trace": [[1, 0]]})
    with pytest.raises(ValueError, match="user axis") as got:
        PC.process_control(bad)
    rcfg = RC.default_cfg()
    rcfg.update(control=RC.parse_control_name("1_10_0.5_iid_fix_a1-e1_bn_1_1"),
                data_name="MNIST", model_name="conv", schedule=bad["schedule"])
    with pytest.raises(ValueError) as ref:
        RC.process_control(rcfg)
    assert str(got.value) == str(ref.value)


# --- the availability draw ----------------------------------------------------------

def _avail(num_users, density, seed):
    return (np.random.default_rng(seed).random(num_users) < density).astype(np.uint8)


@pytest.mark.parametrize("num_users,active,density",
                         [(10, 4, 1.0), (10, 4, 0.5), (100, 10, 0.3), (100, 10, 0.05),
                          (1000, 30, 0.01), (10 ** 5 + 3, 100, 0.2), (16, 16, 0.75),
                          (7, 0, 0.5)])
def test_prp_round_users_with_availability_matches_reference(num_users, active, density):
    """The PRP walk with an availability row: at the reference's round keys
    the cohort is the reference's bit for bit -- available users in PRP
    order, then ``-1`` for the slots the bounded walk could not fill (the
    sparse rows spill) -- and an all-ones row is the uniform cohort."""
    for epoch in (1, 5):
        round_key = jax.random.fold_in(jax.random.PRNGKey(11), epoch)
        _, rk = _reference_keys(round_key, num_users)
        avail = _avail(num_users, density, epoch)
        ref = np.asarray(RCore.round_users(round_key, num_users, active, avail=avail,
                                           sampler="prp"))
        got = S.prp_round_users(rk, num_users, active, avail)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        filled = got[got >= 0]
        assert (avail[filled] == 1).all() and (got[filled.size:] == -1).all()
        ones = S.prp_round_users(rk, num_users, active, np.ones(num_users, np.uint8))
        np.testing.assert_array_equal(ones, S.prp_round_users(rk, num_users, active))
    print(f"parity prp_round_users(avail) U={num_users} A={active} density {density}: "
          f"max_abs_err 0 (bit for bit)")


@pytest.mark.parametrize("num_users,active,density", [(16, 6, 0.2), (100, 10, 0.5), (50, 50, 1.0)])
def test_perm_availability_filter_matches_reference(num_users, active, density):
    """The ``perm`` sampler's filter (a stable sort of the permuted row) on
    the reference's permutation equals the reference's cohort; the port's
    own draw keeps available users first and pads with ``-1``."""
    round_key = jax.random.key(4)
    avail = _avail(num_users, density, 2)
    perm = np.asarray(jax.random.permutation(
        jax.random.fold_in(round_key, RCore.USER_SAMPLE_SALT), num_users))
    ref = np.asarray(RCore.round_users(round_key, num_users, active, avail=avail,
                                       sampler="perm"))
    np.testing.assert_array_equal(core.filter_available(perm, active, avail), ref)
    got = core.round_users(3, num_users, active, "perm", np.random.default_rng(0), avail)
    k = min(active, int(avail.sum()))
    assert (avail[got[:k]] == 1).all() and (got[k:] == -1).all()
    assert np.array_equal(core.round_users(3, num_users, active, "perm",
                                           np.random.default_rng(0)),
                          core.round_users(3, num_users, active, "perm",
                                           np.random.default_rng(0), np.ones(num_users)))


@pytest.mark.parametrize("sampler", ["perm", "prp"])
def test_superstep_schedule_threads_the_availability_rows(sampler):
    """``superstep_user_schedule(schedule=)`` is k K=1 draws, each filtered
    by its round's row of the trace (rows cycling past its length); a
    re-draw from a later epoch (a resume) gives the same cohorts under
    ``prp``."""
    spec = PSched.resolve_schedule_cfg({"num_users": 10, "schedule": MARKOV})
    sched = core.superstep_user_schedule(5, 1, 8, 10, 4, sampler, np.random.default_rng(0),
                                         spec)
    rng = np.random.default_rng(0)
    for r in range(8):
        want = core.round_users(core.round_seed(5, 1 + r), 10, 4, sampler, rng,
                                spec.avail_row(1 + r))
        np.testing.assert_array_equal(sched[r], want)
        filled = sched[r][sched[r] >= 0]
        assert (spec.avail_row(1 + r)[filled] == 1).all()
    assert (sched == -1).any()
    if sampler == "prp":
        np.testing.assert_array_equal(
            core.superstep_user_schedule(5, 5, 4, 10, 4, sampler, None, spec), sched[4:])


# --- rates of padding slots, failures, budgets, the combine ------------------------

def test_padding_slot_takes_the_last_users_rate():
    """A ``-1`` slot's rate is user ``U - 1``'s, as the reference's
    ``jnp.take`` wraps ``-1`` (its ``superstep_rate_schedule``), in the
    port's ``superstep_rate_schedule`` and ``cohort_rates``: the grouped
    engine places the slot in that user's level."""
    for control in ("1_6_1_iid_fix_a2-c2-e2_bn_1_1", "1_5_1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"):
        cfg = PC.default_cfg()
        cfg.update(control=PC.parse_control_name(control), data_name="MNIST", model_name="conv")
        cfg = PC.process_control(cfg)
        users = np.array([[0, -1, 2], [-1, -1, -1]])
        ref = RCore.superstep_rate_schedule(jax.random.key(0), 1, 2, cfg, users)
        got = core.superstep_rate_schedule(0, 1, 2, cfg, users)
        np.testing.assert_array_equal(got, ref)
        assert got[1].tolist() == [cfg["model_rate"][-1]] * 3
        np.testing.assert_array_equal(cohort_rates(cfg, users[0], 0), ref[0])


def test_failure_stream_is_keyed_and_has_its_rate():
    """``client_alive``: the same (round seed, uid) draws the same; a rate
    of 0 fails nobody, 1 everybody; over 20,000 (round, user) draws at
    0.3 the failed share lies within 4 standard errors of 0.3; ``-1``
    draws user 0's."""
    uids = np.arange(200)
    a = core.client_alive(9, uids, 0.3)
    np.testing.assert_array_equal(a, core.client_alive(9, uids, 0.3))
    assert core.client_alive(9, uids, 0.0).all() and not core.client_alive(9, uids, 1.0).any()
    assert core.client_alive(9, [-1], 0.3)[0] == core.client_alive(9, [0], 0.3)[0]
    share = 1.0 - np.mean([core.client_alive(r, uids, 0.3) for r in range(100)])
    assert abs(share - 0.3) < 4 * np.sqrt(0.3 * 0.7 / 20000), share


@pytest.mark.parametrize("total,min_frac", [(5, 0.3), (10, 0.5), (327, 0.5), (1500, 0.05),
                                            (7, 0.999)])
def test_deadline_budgets_match_reference(total, min_frac):
    """Given the reference's speeds (``uniform(fold_in(fold_in(key, 131),
    uid))``), the port's float32 formula gives the reference's budgets bit
    for bit; the port's own budgets lie in ``[ceil(min_frac * total),
    total]`` and depend on (round seed, uid) alone."""
    key = jax.random.key(21)
    uids = np.array([0, 3, 17, 99, -1, 42])
    dkey = jax.random.fold_in(key, RDead.DEADLINE_SALT)
    speeds = np.asarray(jax.vmap(lambda u: jax.random.uniform(jax.random.fold_in(dkey, u)))(
        jnp.maximum(jnp.asarray(uids), 0)))
    ref = np.asarray(RDead.deadline_steps(key, jnp.asarray(uids), total, min_frac))
    np.testing.assert_array_equal(budgets_from_speeds(speeds, total, min_frac), ref)
    edges = budgets_from_speeds(np.array([0.0, np.nextafter(np.float32(1), np.float32(0))],
                                         np.float32), total, min_frac)
    lo = int(np.ceil(np.float32(min_frac) * np.float32(total)))
    assert edges[0] == lo and edges[1] == total
    mine = deadline_steps(4, np.arange(500), total, min_frac)
    assert mine.min() >= lo and mine.max() <= total and mine.dtype == np.int64
    np.testing.assert_array_equal(mine[[3, 9]], deadline_steps(4, [3, 9], total, min_frac))
    print(f"parity deadline budgets total={total} min_frac={min_frac}: max_abs_err 0 "
          f"(bit for bit)")


@pytest.mark.parametrize("alpha", [0.5, 1.0, 0.05])
def test_buffered_combine_matches_reference(alpha):
    """One buffered server step on the same flat params, buffer and fresh
    sums: the new params and buffer are the reference's bit for bit, the
    entries no buffered client held keep their value, and a zero buffer
    (the first round) changes nothing."""
    rng = np.random.default_rng(3)
    n = 1003
    P = rng.normal(size=n).astype(np.float32)
    cnt = rng.integers(0, 4, n).astype(np.float32)
    buf = np.stack([rng.normal(size=n).astype(np.float32) * cnt, cnt])
    summed, counts = rng.normal(size=n).astype(np.float32), rng.integers(0, 3, n).astype(np.float32)
    spec = RBuf.FlatSpec({"w": (n,)})
    r_p, r_buf = RBuf.buffered_combine({"w": jnp.asarray(P)}, jnp.asarray(buf),
                                       {"w": jnp.asarray(summed)}, {"w": jnp.asarray(counts)},
                                       spec, alpha)
    t = torch.from_numpy
    p, b = buffered_combine(t(P), t(buf), t(summed), t(counts), alpha)
    np.testing.assert_array_equal(p.numpy(), np.asarray(r_p["w"]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(r_buf))
    np.testing.assert_array_equal(p.numpy()[cnt == 0], P[cnt == 0])
    p0, _ = buffered_combine(t(P), torch.zeros(2, n), t(summed), t(counts), alpha)
    np.testing.assert_array_equal(p0.numpy(), P)
    print(f"parity buffered_combine alpha={alpha}: max_abs_err 0 (bit for bit)")
