"""The grouped engine's per-level wire-codec map (``wire_codec`` a ``{rate:
codec}`` dict) of the PyTorch/CUDA port against the JAX reference on the
CPU.

Under the map (ref parallel/grouped.py:399-456, :1103-1159) each level's
sliced counted sums go through that level's codec: a dense level ships
float32, a lossy one encodes its sums with its columns of ONE concatenated
error-feedback residual ``[2, total_lossy]`` (lossy levels in descending
rate) on a grid sized for a level's slots -- the most clients a level
holds in the superstep, rounded up to a power of two (``encode(...,
per_dev)``) -- and the global params at its entries; every level is
decoded, embedded and summed before the counted average.

The superstep against the reference's ``GroupedRoundEngine.
train_superstep`` (control ``1_6_1_iid_fix_a2-b1-c1-e2``, map ``{1: int8,
0.5: dense, 0.25: signsgd, 0.0625: int8}``, two rounds, the reference's
``[k, A]`` schedules, client draws and each int8 level's noise
``uniform(fold_in(fold_in(key_r, 9173), 0), (n_l,))`` in its sliced
layout handed in).  Contract, the one-grid-step contract of the int8
superstep (tests/test_torch_port_grouped_superstep.py): params within
5e-5 everywhere but at most 2% of entries, each at most the sum of the
int8 levels' steps ``s_l / count`` covering it (+5e-5) apart; the residual
within 2 x 5e-5 but at most 2% of entries, each at most its level's step
``s_l`` (+1e-4) apart; per-round sums rtol/atol 1e-4, ``n`` exactly.  The
signsgd level is held to atol alone: its decoded sums are ``+-`` a leaf's
mean magnitude, which the two packages sum in another order (a few ulps,
tests/test_torch_port_compress.py), and a sign can only differ where its
``x`` lies within float32 noise of zero, which these data do not have.
The topk codec's rotating block is contiguous in the flat layout, which
differs between the packages inside a leaf (OIHW against HWIO), so a topk
level is held within the port only: resumed against uninterrupted, bit
for bit."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.parallel import GroupedRoundEngine as RGroupedRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress import resolve_codec_cfg
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import flat_from_jax, params_from_jax
from heterofl_tpu_torch.entry import train_classifier_fed
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from test_torch_port_grouped import _vision_data
from test_torch_port_round import reference_draws
from test_torch_port_superstep import _bits

CONTROL = "1_6_1_iid_fix_a2-b1-c1-e2_bn_1_1"  # users 0, 1 at a; 2 at b; 3 at c; 4, 5 at e
USERS = np.array([[0, 1, 2, 4], [3, 4, 5, 0]])  # [k, A]
MAP = {1.0: "int8", 0.5: "dense", 0.25: "signsgd", 0.0625: "int8"}
LR, EPOCH0 = 0.05, 3

few_threads = thread_limit_fixture()


def _cfg(mod, codec=None, control=CONTROL, superstep=2, strategy="grouped"):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(control)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False,
               wire_codec={str(k): v for k, v in (codec or MAP).items()}, error_feedback=True,
               strategy=strategy, superstep_rounds=superstep,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}})
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


@pytest.fixture(scope="module")
def supersteps():
    """Both supersteps from the reference's init, and the port's grid steps
    of round 2."""
    rcfg, pcfg = _cfg(RC), _cfg(PC)
    arrays = _vision_data("MNIST", 6, 360, short=(1, 45))
    k = USERS.shape[0]
    rates = np.asarray(rcfg["model_rate"], np.float32)[USERS]
    E, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    params = {n: np.asarray(v) for n, v in r_make_model(rcfg).init(jax.random.key(0)).items()}
    base_key = jax.random.key(7)
    reng = RGroupedRoundEngine(rcfg, make_mesh(1, 1))
    r_new, pend = reng.train_superstep({n: jnp.asarray(v) for n, v in params.items()}, base_key,
                                       EPOCH0, k, USERS, rates,
                                       tuple(jnp.asarray(a) for a in arrays), lr=LR)
    r_rounds = pend.fetch()
    r_spec = RFlatSpec({n: v.shape for n, v in params.items()})
    r_flat = np.asarray(r_spec.flatten({n: jnp.asarray(v) for n, v in r_new.items()}))
    r_resid = np.asarray(reng.wire_resid_host())

    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params, perms))
    eng = GroupedRoundEngine(model, pcfg, torch.device("cpu"))
    assert eng.codec is None and eng.lossy

    def to_port(ref_flat):  # reference flat layout -> the port's
        leaves = {n: np.asarray(v) for n, v in r_spec.unflatten(jnp.asarray(ref_flat)).items()}
        return eng.spec.flatten(params_from_jax(leaves, perms))

    keys = [jax.random.fold_in(base_key, EPOCH0 + r) for r in range(k)]
    draws = [reference_draws(key, USERS[r], E, N)[0] for r, key in enumerate(keys)]
    noise = [{rate: torch.from_numpy(flat_from_jax(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0),
        (eng.levels[rate].spec.total,), jnp.float32)), eng.levels[rate].spec.shapes, perms))
        for rate, name in MAP.items() if name == "int8"} for key in keys]
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    P0 = eng.flatten(model.params())
    slots = eng.codec_slots(rates)
    assert slots == eng.level_slots(rates) == 2, slots
    # round 1 alone through the engine's round body on the superstep's
    # grid: the params that size round 2's grid steps
    P1, _ = eng._train_round(P0.clone(), LR, USERS[0], data, 0, draws[0], None, rates[0], None,
                             codec_noise=noise[0], codec_slots=slots)
    eng.reset_carries()
    P2, pending = eng.train_superstep(P0.clone(), 0, EPOCH0, k, data, USERS, rates, [LR] * k,
                                      epoch_perms=draws, codec_noise=noise)
    counts = torch.zeros_like(P0)
    step = torch.zeros_like(P0)
    resid_step = torch.zeros(eng.resid_shape()[1])
    for u, rate in zip(USERS[1], rates[1]):
        lv = eng.levels[float(rate)]
        counts.index_add_(0, lv.idx, lv.count_masks(data[-1][[int(u)]])[0])
    for rate, (cobj, off) in eng._map_codecs.items():
        if cobj.name == "int8":
            lv = eng.levels[rate]
            s = cobj.scale_flat(P1.index_select(0, lv.idx), slots)
            step.index_add_(0, lv.idx, s)
            resid_step[off:off + lv.spec.total] = s
    # the reference's [1, 2, total_lossy] residual -> the port's, level by level
    r_res = np.concatenate([flat_from_jax(r_resid[0][:, off:off + spec.total], spec.shapes, perms)
                            for off, spec in eng.resid_segments()], 1)
    return {"ref": (to_port(r_flat), r_rounds, torch.from_numpy(r_res)),
            "port": (P2, pending.fetch(), torch.from_numpy(eng.wire_resid_host())),
            "step": (torch.where(counts > 0, step / counts.clamp_min(1), 0.0), resid_step),
            "engine": eng}


def test_map_superstep_params_and_residual_match_reference(supersteps):
    """Params and the concatenated residual after the two rounds."""
    r_P, _, r_resid = supersteps["ref"]
    P, _, resid = supersteps["port"]
    step, rstep = supersteps["step"]
    eng = supersteps["engine"]
    lossy = [r for r, n in MAP.items() if n != "dense"]
    assert list(eng._map_codecs) == lossy
    total_lossy = sum(eng.levels[r].spec.total for r in lossy)
    assert tuple(resid.shape) == tuple(r_resid.shape) == (2, total_lossy)
    assert_grid_close("per-level map superstep: params after 2 rounds", P, r_P, step, atol=5e-5,
                      max_share=0.02)
    assert_grid_close("per-level map superstep: residual", resid, r_resid, rstep[None],
                      atol=1e-4, max_share=0.02)
    assert bool(torch.all(resid[1] == 0))  # row 1 is topk's only
    for rate, (_, off) in eng._map_codecs.items():  # every lossy level carries a residual
        assert bool(torch.any(resid[0, off:off + eng.levels[rate].spec.total] != 0)), rate


def test_map_superstep_metrics_match_reference(supersteps):
    """Each round's per-client metric sums, in slot order."""
    _, r_rounds, _ = supersteps["ref"]
    _, rounds, _ = supersteps["port"]
    assert len(rounds) == len(r_rounds) == USERS.shape[0]
    for r, (ms, r_ms) in enumerate(zip(rounds, r_rounds), start=1):
        assert_close(f"per-level map superstep round {r}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"per-level map superstep round {r}: {name}", ms[name], r_ms[name],
                         rtol=1e-4, atol=1e-4)


def test_map_refusals_match_reference():
    """As the reference: a map outside ``grouped`` raises naming
    ``strategy='grouped'``; a lossy map at ``superstep_rounds`` 1 raises;
    keys that miss the level table raise naming it (tests/test_sched.py:
    639-655); a map of dense levels is ``dense``."""
    for strategy in ("masked", "sliced"):
        with pytest.raises(ValueError, match="strategy='grouped'"):
            resolve_codec_cfg(dict(_cfg(PC), strategy=strategy))
    with pytest.raises(ValueError, match="fused superstep"):
        _cfg(PC, superstep=1)
    cfg = _cfg(PC)
    with pytest.raises(ValueError, match="level table"):
        GroupedRoundEngine(make_model(cfg), dict(cfg, wire_codec={"1.0": "int8"}),
                           torch.device("cpu"))
    with pytest.raises(ValueError, match="level table"):
        GroupedRoundEngine(make_model(cfg), dict(cfg, wire_codec={**MAP, 0.125: "int8"}),
                           torch.device("cpu"))
    dense = {r: "dense" for r in MAP}
    assert resolve_codec_cfg(dict(cfg, wire_codec=dense)) == ("dense", True)
    eng = GroupedRoundEngine(make_model(cfg), dict(cfg, wire_codec=dense), torch.device("cpu"))
    assert eng.codec is None and eng.codec_map is None and not eng.lossy
    assert not RoundEngine(make_model(cfg), dict(cfg, strategy="masked", wire_codec="dense"),
                           torch.device("cpu")).lossy


def test_map_residual_checkpoint_round_trip(supersteps):
    """The residual blob holds the reference's ``[1, 2, total_lossy]``
    layout (each lossy level's columns in its sliced reference layout) and
    restores the engine's carry bit for bit; a blob of another shape is
    refused."""
    from heterofl_tpu_torch.entry.common import FedExperiment

    eng = supersteps["engine"]
    exp = FedExperiment.__new__(FedExperiment)
    exp.engine, exp.perms = eng, eng.model.jax_perms()
    blob = exp._resid_to_blob()
    assert blob.shape == (1,) + tuple(eng.resid_shape())
    back = exp._resid_from_blob(blob)
    np.testing.assert_array_equal(back, eng.wire_resid_host())
    eng.set_wire_resid(back)
    with pytest.raises(ValueError, match="wire residual"):
        eng.set_wire_resid(back[:1])


def _argv(out, rounds, codec_map):
    return ["--device", "cpu", "--output_dir", str(out), "--control_name",
            "1_4_0.5_iid_fix_a1-b1-e1_bn_1_1", "--data_name", "MNIST", "--model_name", "conv",
            "--synthetic", "1", "--synthetic_sizes", '{"train": 120, "test": 40}',
            "--eval_interval", "3", "--strategy", "grouped", "--superstep_rounds", "2",
            "--pallas_norm", "1", "--wire_codec", json.dumps(codec_map), "--override",
            json.dumps({"num_epochs": {"global": rounds, "local": 1},
                        "conv": {"hidden_size": [8, 16]}})]


def test_map_entry_resume_at_the_boundary_equals_uninterrupted(tmp_path):
    """``train_classifier_fed --strategy grouped --superstep_rounds 2`` with
    the map ``{1: int8, 0.5: topk, 0.0625: signsgd}`` over 3 rounds (a
    superstep and its tail), against 2 rounds and a resumed third: the
    resumed round starts from the checkpoint's params and residual at the
    superstep boundary and ends equal to the uninterrupted run bit for
    bit, params and residual."""
    codec_map = {"1": "int8", "0.5": "topk", "0.0625": "signsgd"}
    (full,) = train_classifier_fed.main(_argv(tmp_path / "full", 3, codec_map))
    train_classifier_fed.main(_argv(tmp_path / "cut", 2, codec_map))
    argv = _argv(tmp_path / "cut", 3, codec_map) + ["--resume_mode", "1"]
    (res,) = train_classifier_fed.main(argv)
    assert [r["epoch"] for r in res["history"]] == [3]
    for k, v in full["params"].items():
        _bits(f"per-level map resumed: {k}", res["params"][k], v)
    assert full["wire_resid"].shape[0] == 2
    _bits("per-level map resumed: residual", res["wire_resid"], full["wire_resid"])
    assert bool(np.any(full["wire_resid"][1] != 0))  # the topk level's count row
    assert all(np.isfinite(np.asarray(v)).all() for v in full["params"].values())
