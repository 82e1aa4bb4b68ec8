"""The superstep's host half in the PyTorch/CUDA port, against the JAX
reference on the CPU: the ``prp`` sampler's keyed permutation bit for bit
at the reference's round keys, the cohort and rate schedules of a
superstep against k single-round draws, the learning rates it stages, the
config refusals with the reference's messages, and the deferred metric
fetch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu.compress import resolve_codec_cfg as r_resolve_codec
from heterofl_tpu.fed import core as RCore
from heterofl_tpu.fed import sampling as RS
from heterofl_tpu.parallel.staging import MetricsPipeline as RMetricsPipeline
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress import resolve_codec_cfg
from heterofl_tpu_torch.fed import core
from heterofl_tpu_torch.fed import sampling as S
from heterofl_tpu_torch.parallel.staging import MetricsPipeline, PendingMetrics, host_fetch
from heterofl_tpu_torch.utils.optim import PlateauScheduler, make_scheduler, superstep_lrs
from heterofl_tpu_torch.testing import thread_limit_fixture


few_threads = thread_limit_fixture()

def _reference_keys(round_key, num_users):
    """The reference's Feistel round keys of a round: the salted sample key,
    then its key schedule (ref fed/core.py:201, fed/sampling.py:218-219)."""
    skey = jax.random.fold_in(round_key, RCore.USER_SAMPLE_SALT)
    _, rounds = RS._feistel_geometry(num_users)
    return skey, np.asarray(jax.random.bits(jax.random.fold_in(skey, RS.PRP_KEY_SALT),
                                            (rounds,), jnp.uint32))


@pytest.mark.parametrize("num_users", [1, 2, 3, 100, 1000, 10 ** 6 + 7])
def test_prp_round_users_matches_reference(num_users):
    """``prp_round_users`` at the reference's round keys equals the
    reference's cohort bit for bit, for every geometry (1 user, the
    smallest domains of 24 Feistel rounds, a non-power-of-four population
    that cycle-walks), and is a set of distinct users."""
    active = min(num_users, 1000)
    for epoch in (1, 7):
        round_key = jax.random.fold_in(jax.random.PRNGKey(3), epoch)
        skey, rk = _reference_keys(round_key, num_users)
        ref = np.asarray(RCore.round_users(round_key, num_users, active, sampler="prp"))
        got = S.prp_round_users(rk, num_users, active)
        assert got.dtype == np.int32 and np.array_equal(got, ref)
        assert len(set(got.tolist())) == active and 0 <= got.min() and got.max() < num_users
    print(f"parity prp_round_users U={num_users} A={active}: max_abs_err 0 (bit for bit)")


@pytest.mark.parametrize("num_users", [5, 17, 100, 4097])
def test_prp_map_is_a_bijection(num_users):
    """The map under the port's own keys permutes ``[0, num_users)``, and
    differs from round to round."""
    maps = [S.prp_map(S.prp_round_keys(core.round_seed(0, e), num_users),
                      np.arange(num_users), num_users) for e in (1, 2)]
    for m in maps:
        assert sorted(m.tolist()) == list(range(num_users))
    assert not np.array_equal(maps[0], maps[1])


def test_round_users_refusals_match_reference():
    """A cohort outside ``[0, num_users]`` and an unknown sampler raise the
    reference's ``ValueError``s; ``perm`` draws the experiment's stream."""
    key = jax.random.PRNGKey(0)
    for bad in (-1, 11):
        with pytest.raises(ValueError, match="num_active=") as r:
            RCore.round_users(key, 10, bad)
        with pytest.raises(ValueError, match="num_active=") as p:
            core.round_users(0, 10, bad)
        assert str(r.value) == str(p.value)
    with pytest.raises(ValueError, match="Not valid sampler"):
        core.round_users(0, 10, 3, "banded")
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    assert np.array_equal(core.round_users(0, 10, 3, "perm", rng_a),
                          rng_b.permutation(10)[:3])


@pytest.mark.parametrize("sampler", ["perm", "prp"])
@pytest.mark.parametrize("mode", ["fix", "dynamic"])
def test_superstep_schedules_equal_k_rounds(sampler, mode):
    """A superstep's ``[k, A]`` cohorts and rates are the k single-round
    draws in round order: the next k permutations of the numpy stream
    (``perm``) or each round seed's PRP image (``prp``), and each round's
    rates (``round_rates`` at its seed in ``dynamic`` mode)."""
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name(f"1_100_0.1_iid_{mode}_a1-b1-c1-d1-e1_bn_1_1")
    cfg = PC.process_control(cfg)
    seed, epoch0, k, A = 3, 5, 4, 10
    users = core.superstep_user_schedule(seed, epoch0, k, 100, A, sampler,
                                         np.random.default_rng(9))
    rates = core.superstep_rate_schedule(seed, epoch0, k, cfg, users)
    rng = np.random.default_rng(9)
    for r in range(k):
        rs = core.round_seed(seed, epoch0 + r)
        assert np.array_equal(users[r], core.round_users(rs, 100, A, sampler, rng))
        want = core.round_rates(rs, cfg, users[r]) if mode == "dynamic" else \
            np.asarray(cfg["model_rate"], np.float32)[users[r]]
        assert np.array_equal(rates[r], want)
    assert users.shape == rates.shape == (k, A) and rates.dtype == np.float32
    assert core.superstep_user_schedule(seed, epoch0, 0, 100, A, "prp").shape == (0, A)


@pytest.mark.parametrize("name", ["MultiStepLR", "CosineAnnealingLR", "ReduceLROnPlateau"])
def test_superstep_lrs_equal_the_rounds(name):
    """The staged learning rates are each round's schedule value rounded
    to float32 as the K=1 round rounds it; Plateau holds its rate for the
    superstep."""
    cfg = {"scheduler_name": name, "lr": 0.1, "factor": 0.1, "milestones": [3, 5],
           "num_epochs": {"global": 8}, "patience": 10, "threshold": 1e-3, "min_lr": 1e-4}
    sched = make_scheduler(cfg)
    lrs = superstep_lrs(sched, 2, 5)
    if isinstance(sched, PlateauScheduler):
        assert np.array_equal(lrs, np.full(5, np.float32(0.1)))
    else:
        want = [torch.full((), float(sched(e)), dtype=torch.float32).item() for e in range(2, 7)]
        assert lrs.dtype == np.float32 and lrs.tolist() == want


def test_sampler_config_matches_reference():
    """``sampler`` takes ``perm`` (the port's default) and ``prp``; an
    unknown one raises the reference's message; ``sample_horizon`` is
    accepted (the schedule commitment)."""
    for kind in ("perm", "prp"):
        assert S.resolve_sampler_cfg({"sampler": kind}).kind == kind
        assert RS.resolve_sampler_cfg({"sampler": kind}).kind == kind
    assert S.resolve_sampler_cfg({}).kind == "perm"
    with pytest.raises(ValueError) as r:
        RS.resolve_sampler_cfg({"sampler": "uniform"})
    with pytest.raises(ValueError) as p:
        S.resolve_sampler_cfg({"sampler": "uniform"})
    assert str(r.value) == str(p.value)
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_100_0.1_iid_fix_a1_bn_1_1")
    assert PC.process_control(dict(cfg, sampler="prp"))["sampler"] == "prp"
    assert PC.process_control(dict(cfg, sample_horizon=1))["sample_horizon"] == 1
    assert S.resolve_sampler_cfg({"sample_horizon": 1}).horizon == \
        RS.resolve_sampler_cfg({"sample_horizon": 1}).horizon == 1


@pytest.mark.parametrize("case,match", [
    ({"superstep_rounds": 2, "strategy": "sliced"}, "needs a mesh-native engine"),
    ({"superstep_rounds": 4, "metrics_fetch_every": 6}, "conflicts with superstep_rounds=4"),
    ({"superstep_rounds": 4, "metrics_fetch_every": 8}, "exceeds superstep_rounds=4"),
    ({"superstep_rounds": 4, "eval_interval": 2, "plateau": True},
     "needs eval boundaries on superstep boundaries"),
    ({"superstep_rounds": 4, "eval_interval": 4, "metrics_fetch_every": 8, "plateau": True},
     "feeds on each superstep's eval metrics"),
])
def test_superstep_config_refusals(case, match):
    """The reference experiment loop's cross-field refusals
    (heterofl_tpu/entry/common.py:336-395), with its messages."""
    case = dict(case)
    plateau = case.pop("plateau", False)
    with pytest.raises(ValueError, match=match):
        PC.resolve_superstep_cfg(case, plateau)


def test_superstep_config_accepts():
    """K and the pipeline's interval in dispatches: ``metrics_fetch_every``
    1 or K at K > 1 (one fetch a superstep either way); any at K=1."""
    assert PC.resolve_superstep_cfg({}) == (1, 1)
    assert PC.resolve_superstep_cfg({"metrics_fetch_every": 3}) == (1, 3)
    assert PC.resolve_superstep_cfg({"superstep_rounds": 4, "metrics_fetch_every": 4}) == (4, 1)
    assert PC.resolve_superstep_cfg({"superstep_rounds": 4, "eval_interval": 8},
                                    plateau=True) == (4, 1)


def test_grouped_lossy_codec_needs_the_superstep():
    """A lossy codec with ``grouped`` is refused at K=1 and accepted at
    K > 1, by both packages' codec checks; so is a per-level map with a
    lossy level (tests/test_torch_port_codec_map.py holds it against the
    reference's superstep)."""
    for resolve in (r_resolve_codec, resolve_codec_cfg):
        for codec in ("int8", {"1.0": "int8"}):
            with pytest.raises(ValueError, match="K=1 host-orchestrated path"):
                resolve({"wire_codec": codec, "strategy": "grouped"})
    assert resolve_codec_cfg({"wire_codec": "int8", "strategy": "grouped",
                              "superstep_rounds": 2})[0] == "int8"
    assert resolve_codec_cfg({"wire_codec": {"1.0": "int8"}, "strategy": "grouped",
                              "superstep_rounds": 2})[0] == {1.0: "int8"}


@pytest.mark.parametrize("fetch_every", [1, 3, 6])
def test_metrics_pipeline_matches_reference(fetch_every):
    """The pipeline at ``fetch_every`` 1, K and 2K (K = 3): a push returns
    what fell due -- everything pending once ``fetch_every`` have
    accumulated -- in push order, as the reference's does; ``flush``
    drains the rest; each fetch is the device sums as host arrays."""
    port, ref = MetricsPipeline(fetch_every), RMetricsPipeline(fetch_every)

    class _Ref:  # the reference's PendingMetrics interface
        def __init__(self, v):
            self.v = v

        def fetch(self):
            return self.v

    due_p, due_r = [], []
    for i in range(7):
        acc = torch.full((2, 3), float(i))
        due_p.append([(t, h["train"][0].tolist()) for t, h in
                      port.push(i, PendingMetrics({"train": [acc]}))])
        due_r.append([(t, h.tolist()) for t, h in ref.push(i, _Ref(acc.numpy()))])
    assert due_p == due_r and len(port) == len(ref) == 7 % fetch_every
    assert [t for t, _ in port.flush()] == [t for t, _ in ref.flush()]


def test_host_fetch_one_copy_keeps_the_tree():
    """``host_fetch`` returns the tree with its float32 leaves as arrays of
    their shapes (one packed copy) and everything else as it was; another
    dtype is refused."""
    tree = {"train": [torch.arange(6.0).view(2, 3)], "eval": [{"bn": {"s": (torch.ones(4),
                                                                          torch.zeros(4))},
                                                               "global": torch.tensor([1.0, 2.0,
                                                                                       3.0])}],
            "note": "x"}
    host = host_fetch(tree)
    assert host["note"] == "x" and host["train"][0].shape == (2, 3)
    assert host["train"][0].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert host["eval"][0]["bn"]["s"][0].tolist() == [1] * 4
    assert host["eval"][0]["global"].tolist() == [1, 2, 3]
    with pytest.raises(TypeError, match="float32"):
        host_fetch({"a": torch.arange(3)})
