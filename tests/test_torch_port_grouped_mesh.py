"""The grouped engine of the PyTorch/CUDA port on the clients mesh axis, on
the CPU: every level's clients spread over the ranks (``span``), or each
level on its own block of ranks (``slices``, sized by its expected FLOP
share), one all-reduce a round.

* the slices table against the JAX engine's ``_static_mesh_slices`` (fix
  and dynamic modes, 2, 3 and 5 ranks, with and without ``slice_align``),
  host arithmetic only; the refusals, the structured warning and
  ``strict_placement``;
* the K=1 ``span`` and ``slices`` rounds at two gloo ranks against the JAX
  package's ``GroupedRoundEngine`` on ``make_mesh(2, 1)``, its epoch
  permutations handed in, at the one-device grouped round tests'
  tolerance (new params atol 5e-5, metric sums rtol/atol 1e-4, ``n`` and
  rates exact); the ranks bit for bit equal; each against the one-rank
  round within ``RANKS_ATOL`` (the levels' sums associate across the
  ranks in one buffer);
* the superstep under the uniform int8 codec and under a per-level map of
  int8, signsgd and dense levels at two ranks under span against the JAX
  engine's on ``make_mesh(2, 1)``, each device's reference noise handed
  in, at the one-device lossy supersteps' one-grid-step contract;
* the superstep under a per-level codec map at two ranks against one:
  ``slices`` bit for bit (each level wholly on one rank, so its
  participants, grid and noise are the one-rank run's), ``span`` (topk and
  dense levels) within ``RANKS_ATOL``;
* exactly one all-reduce a round and one gather a dispatch, counted on
  each rank, dense and under the map;
* the entry at two ranks under the map: resumed == uninterrupted bit for
  bit, the map's residual a row a rank in the sharded checkpoint, and a
  resume at one rank refused by name;
* the sliced twin at two ranks: every rank runs it whole, the one-rank run
  bit for bit; the grouped slices pod probe at two ranks.

The two-rank runs share one spawn of two gloo ranks
(``torch_port_ranks.run_ranks``, its jobs in turn on one group); the
one-rank runs go in this process, without a group."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import flat_from_jax, params_from_jax, params_to_jax
from heterofl_tpu_torch.entry import train_classifier_fed
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine
from heterofl_tpu_torch.parallel import pod
from heterofl_tpu_torch.parallel.grouped import clients_row_chunks, static_mesh_slices
from heterofl_tpu_torch.parallel.mesh import Mesh, single_mesh
from heterofl_tpu_torch.parallel.pod import RANKS_ATOL
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture

from test_torch_port_grouped import _cfg, _vision_data, assert_grouped_matches
from test_torch_port_round import reference_draws
from torch_port_ranks import grouped_job, run_ranks

few_threads = thread_limit_fixture()

LR = 0.05
CPU = torch.device("cpu")

# --- the slices table ------------------------------------------------------------------------

SLICE_CONTROLS = ["1_10_0.5_iid_fix_a2-b3-c2-d2-e1_bn_1_1", "1_8_0.5_iid_fix_a1-e3_bn_1_1",
                  "1_10_0.5_iid_dynamic_a1-b1-c1-d1-e1_bn_1_1"]


def _slice_cfg(mod, control, align):
    cfg = _cfg(mod, control)
    cfg["slice_align"] = align
    return cfg


@pytest.mark.parametrize("align", ["none", "one", "ranks"])
@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("control", SLICE_CONTROLS)
def test_slices_table_matches_reference(control, n, align):
    """Each level's block of ranks equals the JAX engine's
    ``_static_mesh_slices`` on ``make_mesh(n, 1)`` entry for entry, or both
    refuse (fewer rank chunks than levels); ``slice_align`` 0, 1 (one
    chunk: a refusal) and n (chunks of one rank)."""
    align = {"none": 0, "one": 1, "ranks": n}[align]
    rcfg, pcfg = _slice_cfg(RC, control, align), _slice_cfg(PC, control, align)
    ref = RGroupedRoundEngine.__new__(RGroupedRoundEngine)
    ref.cfg, ref.mesh = rcfg, make_mesh(n, 1)
    levels = sorted({float(r) for r in rcfg["model_rate"]}, reverse=True)
    ref.levels = dict.fromkeys(levels)
    r_slices, r_reason = ref._static_mesh_slices()
    p_slices, p_reason = static_mesh_slices(pcfg, levels, n)
    assert p_slices == {float(r): tuple(int(x) for x in lh) for r, lh in r_slices.items()}
    assert bool(p_reason) == bool(r_reason) == (not p_slices)
    if p_slices:
        assert sorted(p_slices.values())[0][0] == 0 and max(hi for _, hi in p_slices.values()) == n


def test_slices_refusals_warning_and_strict():
    """One rank cannot lay out two levels: a structured warning and
    ``span`` (the reference's engine on ``make_mesh(1, 1)`` warns alike), or
    ``ValueError`` under ``strict_placement`` in both packages; a mesh of two
    ranks lays them out; a ``slice_align`` that does not divide the ranks
    refuses; a single level leaves nothing to slice.  The config takes
    ``slice_align`` (an int >= 0) and ``strict_placement`` (a bool);
    ``level_placement`` is out of ``UNPORTED``, and the clients axis no
    longer refuses grouped, sliced or slices."""
    control = "1_4_1_iid_fix_a2-e2_bn_1_1"
    pcfg = dict(_cfg(PC, control), level_placement="slices")
    rcfg = dict(_cfg(RC, control), level_placement="slices")
    model = make_model(pcfg)
    for cfg, engine in ((pcfg, lambda c: GroupedRoundEngine(model, c, CPU)),
                        (rcfg, lambda c: RGroupedRoundEngine(c, make_mesh(1, 1)))):
        with pytest.warns(UserWarning, match="falling back to 'span'.*slices-fallback"):
            eng = engine(cfg)
        assert eng.level_placement == "span"
        with pytest.raises(ValueError, match="strict_placement is set: 1 clients rows"):
            engine(dict(cfg, strict_placement=True))
    two = GroupedRoundEngine(model, dict(pcfg, strict_placement=True), CPU, Mesh(0, 2, CPU))
    assert two.level_placement == "slices" and two.slices == {1.0: (0, 1), 0.0625: (1, 2)}
    assert [two._block(r, 2, d) for r in (1.0, 0.0625) for d in (0, 1)] == \
        [(0, 2), (0, 0), (0, 0), (0, 2)]
    assert clients_row_chunks(4, 2) == [(0, 2), (2, 4)] and clients_row_chunks(3, 2) is None
    with pytest.raises(ValueError, match="does not divide the 3 ranks"):
        GroupedRoundEngine(model, dict(pcfg, strict_placement=True, slice_align=2), CPU,
                           Mesh(0, 3, CPU))
    assert static_mesh_slices(_cfg(PC, "1_4_1_iid_fix_a4_bn_1_1"), [1.0], 4) == \
        ({}, "a single level leaves nothing to slice")
    base = PC.default_cfg()
    base["control"] = PC.parse_control_name(control)
    base.update(data_name="MNIST", model_name="conv", strategy="grouped")
    for bad in ({"slice_align": -1}, {"slice_align": "2"}, {"slice_align": True},
                {"strict_placement": "yes"}):
        with pytest.raises(ValueError, match="Not valid (slice_align|strict_placement)"):
            PC.process_control(dict(base, **bad))
    done = PC.process_control(dict(base, level_placement="slices", slice_align=2,
                                   strict_placement=True))
    assert (done["slice_align"], done["strict_placement"]) == (2, True)
    assert PC.UNPORTED == {} and "level_placement" in PC.DEFAULT_CFG
    assert not any(what in ("strategy='grouped'", "strategy='sliced'", "level_placement='slices'")
                   for _, what, _ in PC.MESH_REFUSALS)
    for over in ({}, {"level_placement": "slices"}, {"strategy": "sliced"}):
        PC.resolve_mesh_cfg(dict(base, **over), world=2)


# --- two ranks against the JAX package's make_mesh(2, 1) ----------------------------------------

CONTROL = "1_4_1_iid_fix_a2-e2_bn_1_1"  # users 0, 1 at level a; 2, 3 at level e
USERS = np.arange(4)
MAP_CONTROL = "1_6_1_iid_fix_a2-c2-e2_bn_1_1"  # two clients at each of levels a, c, e
SPAN_MAP = {"1": "topk", "0.25": "dense", "0.0625": "topk"}
#: under slices the level on rank 1 draws rank 1's noise: a topk level draws
#: none, so the map's run equals the one-rank run's bit for bit
SLICES_MAP = {"1": "int8", "0.0625": "topk"}
SS_USERS = np.array([[0, 2, 3, 5], [1, 4, 0, 3]])


def _reference_round(rcfg, arrays, placement, params_np):
    eng = RGroupedRoundEngine(dict(rcfg, level_placement=placement), make_mesh(2, 1))
    users = np.asarray(USERS, np.int32)
    rates = np.asarray(rcfg["model_rate"], np.float32)[users]
    r_new, r_ms = eng.train_round({k: jnp.asarray(v) for k, v in params_np.items()}, users,
                                  rates, tuple(jnp.asarray(a) for a in arrays), LR,
                                  jax.random.key(3))
    return ({k: np.asarray(v) for k, v in r_new.items()},
            {k: np.asarray(v) for k, v in r_ms.items()}, dict(eng._slices))


def _superstep_job(control, codec, placement, k, users):
    pcfg = dict(_cfg(PC, control, local=1), wire_codec=codec, superstep_rounds=2,
                level_placement=placement, strict_placement=placement == "slices")
    model = make_model(pcfg)
    params = params_to_jax(model.init_(torch.Generator().manual_seed(0)).params(),
                           model.jax_perms())
    users = np.asarray(users[:k])
    rates = np.asarray(pcfg["model_rate"], np.float32)[users]
    return dict(kind="grouped", cfg=pcfg, params={n: np.asarray(v) for n, v in params.items()},
                data=_vision_data("MNIST", 6, 120), users=users, rates=rates, k=k, seed=5,
                lr=LR)


#: the lossy supersteps held against the reference's on make_mesh(2, 1):
#: the uniform int8 codec, and a per-level map of int8, signsgd and dense
#: levels, both under span on MAP_CONTROL's SS_USERS
REF_CODECS = {"int8": "int8", "map": {"1": "int8", "0.25": "signsgd", "0.0625": "dense"}}
EPOCH0 = 3


def _ss_cfg(mod, codec):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(MAP_CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, wire_codec=codec,
               error_feedback=True, strategy="grouped", superstep_rounds=2,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}})
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def _two_participant_engine(pcfg):
    """The port's engine laid out for two ranks (no group): its codecs count
    two participants, as each rank's do."""
    return GroupedRoundEngine(make_model(pcfg), pcfg, CPU, Mesh(0, 2, CPU))


def _reference_lossy_superstep(codec, arrays, params):
    """The reference's superstep (two rounds from ``EPOCH0``, key 7) on
    ``make_mesh(2, 1)`` under ``codec`` -> its results in the port's flat
    layout (params, each device's residual row(s)), its metric rounds, and
    the port's job: the same init, the reference's client draws and each
    device's int8 noise (``uniform(fold_in(fold_in(key_r, 9173), d))``, of
    the whole flat or of each int8 level's sliced flat) handed in."""
    rcfg, pcfg = _ss_cfg(RC, codec), _ss_cfg(PC, codec)
    rates = np.asarray(rcfg["model_rate"], np.float32)[SS_USERS]
    k, base = SS_USERS.shape[0], jax.random.key(7)
    reng = RGroupedRoundEngine(rcfg, make_mesh(2, 1))
    r_new, pend = reng.train_superstep({n: jnp.asarray(v) for n, v in params.items()}, base,
                                       EPOCH0, k, SS_USERS, rates,
                                       tuple(jnp.asarray(a) for a in arrays), lr=LR)
    r_rounds = pend.fetch()
    r_resid = np.asarray(reng.wire_resid_host())
    eng = _two_participant_engine(pcfg)
    perms = make_model(pcfg).jax_perms()
    flat = eng.spec.flatten(params_from_jax({n: np.asarray(v) for n, v in r_new.items()}, perms))
    if eng.codec is not None:
        r_res = [flat_from_jax(r_resid[d], eng.spec.shapes, perms) for d in range(2)]
    else:
        r_res = [np.concatenate([flat_from_jax(r_resid[d][:, off:off + spec.total], spec.shapes,
                                               perms) for off, spec in eng.resid_segments()], 1)
                 for d in range(2)]
    keys = [jax.random.fold_in(base, EPOCH0 + r) for r in range(k)]
    draws = [reference_draws(key, SS_USERS[r], 1, arrays[0].shape[1])[0]
             for r, key in enumerate(keys)]

    def noise(key, d, spec):
        u = jax.random.uniform(jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), d),
                               (spec.total,), jnp.float32)
        return flat_from_jax(np.asarray(u), spec.shapes, perms)

    def rank_noise(key, d):
        if eng.codec is not None:
            return noise(key, d, eng.spec)
        return {rate: noise(key, d, eng.levels[rate].spec)
                for rate, (cobj, _) in eng._map_codecs.items() if cobj.name == "int8"}

    job = dict(kind="grouped", cfg=pcfg, params=params, data=arrays, users=SS_USERS, rates=rates,
               k=k, seed=0, epoch0=EPOCH0, lr=LR, epoch_perms=draws, first_round=True,
               codec_noise=[[rank_noise(key, d) for key in keys] for d in range(2)])
    return (flat.numpy(), r_res, r_rounds), job


def _entry_argv(out_dir, rounds, resume=0):
    return ["--device", "cpu", "--control_name", "1_8_0.5_iid_fix_a1-e1_bn_1_1", "--data_name",
            "MNIST", "--model_name", "conv", "--synthetic", "1", "--synthetic_sizes",
            '{"train": 160, "test": 40}', "--strategy", "grouped", "--superstep_rounds", "2",
            "--wire_codec", '{"1": "int8", "0.0625": "topk"}', "--resume_mode", str(resume),
            "--output_dir", out_dir, "--override",
            '{"num_epochs": {"global": %d, "local": 1}, "conv": {"hidden_size": [4, 8]}}'
            % rounds]


@pytest.fixture(scope="module")
def case():
    """The reference's K=1 span and slices rounds on ``make_mesh(2, 1)``
    from its key-0 init, their draws, and the port's jobs."""
    rcfg, pcfg = _cfg(RC, CONTROL), _cfg(PC, CONTROL)
    arrays = _vision_data("MNIST", 4, 160)
    rmodel = r_make_model(rcfg)
    params = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    perms, _ = reference_draws(jax.random.key(3), USERS, rcfg["num_epochs"]["local"],
                               arrays[0].shape[1])
    ref = {lp: _reference_round(rcfg, arrays, lp, params) for lp in ("span", "slices")}
    ss_arrays = _vision_data("MNIST", 6, 120)
    ss_params = {k: np.asarray(v) for k, v in r_make_model(_ss_cfg(RC, "int8")).init(
        jax.random.key(0)).items()}
    ref_jobs = {}
    for name, codec in REF_CODECS.items():
        ref[f"ss_{name}"], ref_jobs[f"ref_{name}"] = _reference_lossy_superstep(
            codec, ss_arrays, ss_params)
    round_job = dict(kind="grouped", params=params, data=arrays, users=USERS, lr=LR,
                     epoch_perms=perms)
    jobs = {"span": dict(round_job, cfg=pcfg),
            "slices": dict(round_job, cfg=dict(pcfg, level_placement="slices",
                                               strict_placement=True)),
            "twin": dict(round_job, cfg=dict(pcfg, strategy="sliced"), engine="sliced"),
            "map_span": _superstep_job(MAP_CONTROL, SPAN_MAP, "span", 2, SS_USERS),
            "map_slices": _superstep_job(CONTROL, SLICES_MAP, "slices", 2,
                                         np.array([[0, 1, 2, 3], [3, 0, 2, 1]])),
            **ref_jobs}
    return ref, jobs


@pytest.fixture(scope="module")
def two_ranks(case, tmp_path_factory):
    """Every two-rank run of this file in one spawn of two gloo ranks: the
    jobs of :func:`case`, the entry uninterrupted, cut and resumed, then
    the probe's rank -> {name: [rank 0's result, rank 1's]}."""
    _, jobs = case
    out = tmp_path_factory.mktemp("grouped_mesh")
    names = list(jobs)
    seq = [jobs[n] for n in names]
    for name, argv in (("full", _entry_argv(str(out / "full"), 4)),
                       ("part", _entry_argv(str(out / "part"), 2)),
                       ("resumed", _entry_argv(str(out / "part"), 4, resume=1))):
        names.append(name)
        seq.append(dict(kind="entry", entry="train_classifier_fed", argv=argv))
    names.append("probe")
    seq.append(dict(kind="probe"))
    ranks = run_ranks(dict(kind="seq", jobs=seq, deterministic=True), 2, str(out / "ranks"),
                      timeout_s=600)
    assert [rk["foreign_modules"] for rk in ranks] == [[], []]  # the rank jobs load no JAX
    res = {name: [rk["results"][i] for rk in ranks] for i, name in enumerate(names)}
    res["_dir"] = str(out)
    return res


def _one_rank(job):
    """The job on one rank without a group, under ``span`` (the one
    placement one rank lays out), on one thread under deterministic
    algorithms as the ranks run it."""
    cfg = dict(job["cfg"], level_placement="span", strict_placement=False)
    threads, det = torch.get_num_threads(), torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    try:
        return grouped_job(dict(job, cfg=cfg), single_mesh(CPU), torch)
    finally:
        torch.set_num_threads(threads)
        torch.use_deterministic_algorithms(det)


@pytest.mark.parametrize("placement", ["span", "slices"])
def test_k1_round_at_two_ranks_matches_reference_mesh(case, two_ranks, placement):
    """The K=1 round at two gloo ranks against the reference's on
    ``make_mesh(2, 1)``: span, each rank one client of each level; slices,
    level a on rank 0 and level e on rank 1, the slices table the
    reference's.  The ranks equal bit for bit, one all-reduce and one
    gather a round on each."""
    ref, _ = case
    r_new, r_ms, r_slices = ref[placement]
    outs = two_ranks[placement]
    for r, out in enumerate(outs):
        assert np.array_equal(out["flat"], outs[0]["flat"]), f"rank {r} params"
        for k in ("loss_sum", "score_sum", "n"):
            assert np.array_equal(out["round"][k], outs[0]["round"][k]), f"rank {r} {k}"
        assert (out["collectives"]["all_reduce"], out["collectives"]["gather"]) == (1, 1)
        assert out["placement"] == placement
    assert outs[0]["slices"] == {float(r): tuple(int(x) for x in lh)
                                 for r, lh in r_slices.items()}
    assert bool(outs[0]["slices"]) == (placement == "slices")
    assert_grouped_matches(f"grouped K=1 {placement} round, 2 ranks vs make_mesh(2, 1)",
                           outs[0]["params"], outs[0]["round"], r_new, r_ms)


@pytest.mark.parametrize("placement", ["span", "slices"])
def test_k1_round_at_two_ranks_against_one_rank(case, two_ranks, placement):
    """The two-rank round against the one-rank round (no group): within
    ``RANKS_ATOL`` on params (each level's sums meet the other ranks' in
    one float32 buffer, a rounding apart), the metric rows equal."""
    _, jobs = case
    one = _one_rank(jobs[placement])
    two = two_ranks[placement][0]
    assert one["placement"] == "span"
    assert_close(f"grouped K=1 {placement}: 2 ranks vs 1 rank, params", two["flat"], one["flat"],
                 rtol=0, atol=RANKS_ATOL)
    for k in ("loss_sum", "score_sum", "n"):
        np.testing.assert_array_equal(two["round"][k], one["round"][k])


@pytest.mark.parametrize("codec", list(REF_CODECS))
def test_lossy_superstep_at_two_ranks_matches_reference_mesh(case, two_ranks, codec):
    """The superstep (two rounds) under a lossy codec at two gloo ranks
    under span against the reference's on ``make_mesh(2, 1)``: the uniform
    int8 codec (its grid sized for every level's slots), and a per-level
    map of int8, signsgd and dense levels in one all-reduce a round.  Each
    rank encodes its partial sums with its own residual row and its
    device's reference noise, two participants to a codec.  Contract (the
    one-device lossy supersteps', tests/test_torch_port_grouped_superstep.py
    and tests/test_torch_port_codec_map.py): params within 5e-5 but at most
    2% of entries, each at most the int8 grid steps ``s / count`` covering
    it (+5e-5) apart, the signsgd level within 5e-5; each rank's residual
    within its atol but at most 2% of entries one step ``s`` apart; per-round
    sums rtol/atol 1e-4, ``n`` exactly; the ranks' params bit for bit equal
    and their residual rows apart."""
    ref, jobs = case
    r_flat, r_resid, r_rounds = ref[f"ss_{codec}"]
    job, outs = jobs[f"ref_{codec}"], two_ranks[f"ref_{codec}"]
    assert np.array_equal(outs[0]["flat"], outs[1]["flat"])
    assert np.array_equal(outs[0]["first"], outs[1]["first"])
    assert not np.array_equal(outs[0]["resid"], outs[1]["resid"])
    assert [o["placement"] for o in outs] == ["span", "span"]
    eng = _two_participant_engine(job["cfg"])
    data = tuple(torch.from_numpy(np.asarray(a)) for a in job["data"])
    P1, cmax = torch.from_numpy(outs[0]["first"]), eng.codec_slots(job["rates"])
    counts = torch.zeros_like(P1)
    for u, rate in zip(job["users"][1], job["rates"][1]):  # round 2's clients
        lv = eng.levels[float(rate)]
        counts.index_add_(0, lv.idx, lv.count_masks(data[-1][[int(u)]])[0])
    if eng.codec is not None:
        step = rstep = eng.codec.scale_flat(P1, cmax)
        r_atol = 5e-5 * job["users"].shape[1]
    else:
        step, rstep, r_atol = torch.zeros_like(P1), torch.zeros(eng.resid_shape()[1]), 1e-4
        for rate, (cobj, off) in eng._map_codecs.items():
            if cobj.name == "int8":
                lv = eng.levels[rate]
                s = cobj.scale_flat(P1.index_select(0, lv.idx), cmax)
                step.index_add_(0, lv.idx, s)
                rstep[off:off + lv.spec.total] = s
    what = f"grouped {codec} superstep span, 2 ranks vs make_mesh(2, 1)"
    assert_grid_close(f"{what}: params after 2 rounds", outs[0]["flat"], r_flat,
                      torch.where(counts > 0, step / counts.clamp_min(1), 0.0), atol=5e-5,
                      max_share=0.02)
    for d, out in enumerate(outs):
        assert out["resid"].shape == r_resid[d].shape
        assert_grid_close(f"{what}: rank {d} residual", out["resid"], r_resid[d], rstep[None],
                          atol=r_atol, max_share=0.02)
    assert len(outs[0]["round"]) == len(r_rounds) == 2
    for r, (ms, r_ms) in enumerate(zip(outs[0]["round"], r_rounds), start=1):
        assert_close(f"{what} round {r}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"{what} round {r}: {name}", ms[name], r_ms[name], rtol=1e-4, atol=1e-4)


def test_map_superstep_slices_at_two_ranks_is_the_one_rank_run(case, two_ranks):
    """The superstep (two rounds) under the per-level map at two ranks under
    slices: each level wholly on one rank, so each lossy level has the
    one-rank run's participants, grid and noise, and the round's sums meet
    zeros from the other rank -- the one-rank run bit for bit, params,
    residual and metric rows; two all-reduces (a round) and one gather."""
    _, jobs = case
    one = _one_rank(jobs["map_slices"])
    outs = two_ranks["map_slices"]
    for out in outs:
        assert out["placement"] == "slices"
        assert (out["collectives"]["all_reduce"], out["collectives"]["gather"]) == (2, 1)
        assert np.array_equal(out["flat"], one["flat"])
        for r, (rd, r1) in enumerate(zip(out["round"], one["round"])):
            for k in ("loss_sum", "score_sum", "n", "rate"):
                np.testing.assert_array_equal(rd[k], r1[k], err_msg=f"round {r} {k}")
    # each rank's residual row: its own level's columns, zeros at the other's
    assert np.array_equal(outs[0]["resid"] + outs[1]["resid"], one["resid"])
    assert outs[0]["resid"].any() and outs[1]["resid"].any()


def test_map_superstep_span_at_two_ranks_against_one_rank(case, two_ranks):
    """The superstep (two rounds) under a per-level map of topk and dense
    levels at two ranks under span -- every level's clients split over the
    ranks, each rank encoding every lossy level with its own residual row,
    every level's payload in one all-reduce a round -- against the one-rank
    run: the ranks bit for bit equal, two all-reduces and one gather;
    params within ``RANKS_ATOL`` (topk ships the same block from every
    rank, so the decoded sums are the one-rank run's up to association)
    and the first round's metric rows equal.  (An int8 level's grid and
    noise depend on its participants, so its two-rank run is its own:
    held against the reference's above, bit for bit under slices and
    resumed in the entry below.)"""
    _, jobs = case
    one = _one_rank(jobs["map_span"])
    outs = two_ranks["map_span"]
    assert np.array_equal(outs[0]["flat"], outs[1]["flat"])
    assert [(o["collectives"]["all_reduce"], o["collectives"]["gather"]) for o in outs] == \
        [(2, 1), (2, 1)]
    assert_close("grouped map superstep span, 2 ranks vs 1 rank, params", outs[0]["flat"],
                 one["flat"], rtol=0, atol=RANKS_ATOL)
    for k in ("loss_sum", "score_sum", "n"):
        np.testing.assert_array_equal(outs[0]["round"][0][k], one["round"][0][k])


def test_sliced_twin_at_two_ranks_is_the_one_rank_run(case, two_ranks):
    """The sliced twin at two ranks: every rank runs it whole and reduces
    nothing -- each rank the one-rank run bit for bit."""
    _, jobs = case
    one = _one_rank(jobs["twin"])
    for out in two_ranks["twin"]:
        assert np.array_equal(out["flat"], one["flat"])
        assert out["collectives"]["all_reduce"] == 0


def test_entry_at_two_ranks_resumes_bit_for_bit(two_ranks):
    """The entry at two ranks under the per-level map (int8 and topk, span):
    two supersteps uninterrupted against one, then resumed from its sharded
    checkpoint (the map's ``[2, total_lossy]`` residual a row a rank, the
    layout in the header): params, history and residual bit for bit, the
    ranks' residual rows apart; resuming it at one rank is refused by
    name."""
    full, resumed = two_ranks["full"], two_ranks["resumed"]
    for a, b in zip(full, resumed):
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
            np.testing.assert_array_equal(a["params"][k], full[0]["params"][k], err_msg=k)
        np.testing.assert_array_equal(a["wire_resid"], b["wire_resid"])
        assert [h["epoch"] for h in b["history"]] == [3, 4]
        assert [h["loss"] for h in b["history"]] == [h["loss"] for h in a["history"][2:]]
    assert not np.array_equal(full[0]["wire_resid"], full[1]["wire_resid"])
    assert full[0]["collectives"]["all_reduce"] == full[1]["collectives"]["all_reduce"]
    model_dir = os.path.join(two_ranks["_dir"], "part", "model")
    assert any(".shard00" in f for f in os.listdir(model_dir))
    with pytest.raises(ValueError, match="grouped engine ran with ranks=2, this run has ranks=1"):
        train_classifier_fed.main(_entry_argv(os.path.join(two_ranks["_dir"], "part"), 6,
                                              resume=1))


def test_grouped_slices_pod_probe_at_two_ranks(two_ranks):
    """The reference's probe: the grouped slices superstep under
    ``strict_placement`` at two ranks (level a on rank 0, level b on rank
    1), the ranks bit for bit equal, one all-reduce a round, the sharded
    checkpoint read back, and against the one-rank (span) run."""
    many = os.path.join(two_ranks["_dir"], "ranks", "probe")
    res = two_ranks["probe"]
    assert [r["placement"] for r in res] == ["slices", "slices"]
    assert res[0]["slices"] == {"1": [0, 1], "0.5": [1, 2]}
    one = os.path.join(two_ranks["_dir"], "probe_one")
    threads = torch.get_num_threads()
    try:
        res1 = pod.child_main(one)
    finally:
        torch.set_num_threads(threads)
    assert res1["placement"] == "span" and res1["slices"] == {}
    cmp = pod.compare_probes(many, res, one, [res1])
    assert cmp["ranks_equal"] and cmp["within_tolerance"] and cmp["sharded_ckpt_ok"]
    assert cmp["all_reduce_per_round"] == [1.0, 1.0]
    assert cmp["placements"] == ["slices", "slices"]
