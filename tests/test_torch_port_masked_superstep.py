"""The masked engine's superstep of the PyTorch/CUDA port against the JAX
reference's ``RoundEngine.train_superstep`` on the CPU (``make_mesh(1,
1)``), its fused evaluation included.

Two rounds as one superstep, dense and with the int8 codec (error
feedback on), from the same params, ``[k, A]`` user schedule and learning
rate, with the reference's client draws (``reference_draws`` at each
round's key ``fold_in(base_key, epoch0 + r)``) and, for int8, its codec
noise (``uniform(fold_in(fold_in(key_r, 9173), 0), (total,))``, the draw
inside its ``shard_map``) handed in.  The eval mask fires on round 1, so
round 2 trains on after an evaluation inside the superstep: the
reference's fused evaluation (``eval_fused_scan``) and the port's
``FusedEval`` run sBN, Local and Global on each side's round-1 params.

Contracts:

* dense params after the two rounds within 5e-5 (a masked round's
  contract against the reference, ``assert_round_matches``);
* int8, as the masked engine's two int8 rounds against the reference's
  (tests/test_torch_port_compress.py): params within 5e-5 everywhere but
  at most 2% of entries, each at most one grid step ``s_leaf / count``
  (+5e-5) apart; the residual within 4 x 5e-5 but at most 2% of entries,
  each at most one step ``s_leaf`` (+2e-4) apart;
* each round's per-client metric sums at rtol/atol 1e-4, ``n`` exactly;
* the evaluation: sBN statistics at rtol 1e-4 / atol 1e-5 (the
  evaluator's contract, tests/test_torch_port_eval.py), the Local and
  Global sums at rtol/atol 1e-4, ``n`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.entry.common import stage_eval_operands as r_stage_eval_operands
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.parallel.evaluation import Evaluator as REvaluator
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.data import label_split_masks, split_dataset
from heterofl_tpu_torch.entry.common import stage_eval_operands
from heterofl_tpu_torch.fed.core import to_width_rates
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import Evaluator, RoundEngine
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from test_torch_port_round import CONTROL, LR, _data, reference_draws

USERS = np.array([[0, 1, 2, 3], [2, 3, 0, 1]])  # [k, A]; rates 1, 0.5, 0.25, 0.0625
EPOCH0 = 3
EVAL_MASK = (True, False)

few_threads = thread_limit_fixture()


def _cfg(mod, codec):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, wire_codec=codec,
               error_feedback=True, superstep_rounds=2,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]},
                         "batch_size": {"train": 10, "test": 10}})
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def _eval_operands(pcfg, rcfg):
    """Both sides' eval operands from one synthetic set (55 train images
    -> 6 sBN batches, the last half padding; 40 test images over the 4
    users), checked equal."""
    ds = r_fetch("MNIST", synthetic=True, seed=1, synthetic_sizes={"train": 55, "test": 40})
    split, lsplit = split_dataset(ds, 4, "iid", np.random.default_rng(0), classes_size=10)
    lm = label_split_masks(lsplit, 4, 10)
    ops = stage_eval_operands(pcfg, ds["train"], ds["test"], split["test"], lm)
    r_ops = r_stage_eval_operands(rcfg, ds["train"], ds["test"], split["test"], lm)
    for a, b in zip(jax.tree_util.tree_leaves(ops), jax.tree_util.tree_leaves(r_ops)):
        np.testing.assert_array_equal(a, b)
    return ops


@pytest.fixture(scope="module", params=["dense", "int8"])
def supersteps(request):
    """Both supersteps from the reference's init."""
    codec = request.param
    rcfg, pcfg = _cfg(RC, codec), _cfg(PC, codec)
    arrays = _data()
    k, A = USERS.shape
    E, N = rcfg["num_epochs"]["local"], arrays[0].shape[1]
    sbn, local, glob = _eval_operands(pcfg, rcfg)
    rmodel = r_make_model(rcfg)
    params = {n: np.asarray(v) for n, v in rmodel.init(jax.random.key(0)).items()}
    base_key = jax.random.key(7)
    reng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
    rfe = REvaluator(rmodel, rcfg, make_mesh(1, 1), seed=0).fused(
        sbn_batches=sbn, local_eval=local, global_eval=glob)
    r_new, pend = reng.train_superstep({n: jnp.asarray(v) for n, v in params.items()}, base_key,
                                       EPOCH0, k, tuple(jnp.asarray(a) for a in arrays),
                                       user_schedule=USERS, eval_mask=EVAL_MASK,
                                       fused_eval=rfe, lr=LR)
    r_out = pend.fetch()
    rspec = RFlatSpec({n: v.shape for n, v in params.items()})
    r_flat = np.asarray(rspec.flatten({n: jnp.asarray(v) for n, v in r_new.items()}))
    r_resid = reng.wire_resid_host()

    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params))
    eng = RoundEngine(model, pcfg, torch.device("cpu"))
    spec = eng.spec

    def to_port(ref_flat):  # reference flat layout -> the port's
        leaves = {n: np.asarray(v) for n, v in rspec.unflatten(jnp.asarray(ref_flat)).items()}
        return spec.flatten(params_from_jax(leaves))

    keys = [jax.random.fold_in(base_key, EPOCH0 + r) for r in range(k)]
    draws = [reference_draws(key, USERS[r], E, N)[0] for r, key in enumerate(keys)]
    noise = None if codec == "dense" else [to_port(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0), (rspec.total,),
        jnp.float32))) for key in keys]
    t = torch.from_numpy
    fe = Evaluator(model, pcfg, torch.device("cpu"), seed=0).fused(
        spec, tuple(map(t, sbn)), tuple(map(t, local)), tuple(map(t, glob)))
    data = tuple(t(np.asarray(a)) for a in arrays)
    rates = eng.fix_rates[USERS]
    P0 = eng.flatten(model.params())
    out = {"codec": codec, "A": A}
    if codec == "int8":
        # round 1 alone through the K=1 round (equal to the superstep's
        # first round bit for bit, tests/test_torch_port_superstep.py):
        # the params that size round 2's grid step
        P1, _ = eng.train_round(P0.clone(), LR, USERS[0], data, 0, epoch_perms=draws[0],
                                codec_noise=noise[0])
        eng.reset_carries()
        counts = torch.stack([eng.count_mask_flat(float(wr), data[3][u]) for u, wr in
                              zip(USERS[1], to_width_rates(rates[1], pcfg))]).sum(0)
        s = eng.codec.scale_flat(P1, A)
        out["step"] = (torch.where(counts > 0, s / counts.clamp_min(1), 0.0), s)
    P2, pending = eng.train_superstep(P0.clone(), 0, EPOCH0, k, data, USERS, rates, [LR] * k,
                                      eval_mask=EVAL_MASK, fused_eval=fe, epoch_perms=draws,
                                      codec_noise=noise)
    out["ref"] = (to_port(r_flat), r_out,
                  None if r_resid is None else to_port(r_resid.reshape(-1, rspec.total)[0]))
    out["port"] = (P2, pending.fetch(), eng.wire_resid_host())
    return out


def test_masked_superstep_params_match_reference(supersteps):
    """Params (and, int8, the error-feedback residual) after the two rounds."""
    r_P, _, r_resid = supersteps["ref"]
    P, _, resid = supersteps["port"]
    case = f"masked {supersteps['codec']} superstep"
    if supersteps["codec"] == "dense":
        assert resid is None and r_resid is None
        assert_close(f"{case}: params after 2 rounds", P, r_P, rtol=0, atol=5e-5)
        return
    step, s = supersteps["step"]
    assert resid.shape == (1, r_P.numel())
    assert_grid_close(f"{case}: params after 2 rounds", P, r_P, step, atol=5e-5,
                      max_share=0.02)
    assert_grid_close(f"{case}: residual", resid[0], r_resid, s, atol=5e-5 * supersteps["A"],
                      max_share=0.02)
    assert bool(np.any(resid != 0))


def test_masked_superstep_metrics_match_reference(supersteps):
    """Each round's per-client metric sums, in slot order."""
    _, r_out, _ = supersteps["ref"]
    _, out, _ = supersteps["port"]
    case = f"masked {supersteps['codec']} superstep"
    assert len(out["train"]) == len(r_out["train"]) == USERS.shape[0]
    for r, (ms, r_ms) in enumerate(zip(out["train"], r_out["train"]), start=1):
        assert_close(f"{case} round {r}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"{case} round {r}: {name}", ms[name], r_ms[name], rtol=1e-4,
                         atol=1e-4)


def test_masked_superstep_fused_eval_matches_reference(supersteps):
    """The fused evaluation of round 1: its epoch, every BN site's sBN
    statistics, the per-user Local and the Global sums."""
    _, r_out, _ = supersteps["ref"]
    _, out, _ = supersteps["port"]
    case = f"masked {supersteps['codec']} superstep eval"
    assert len(out["eval"]) == len(r_out["eval"]) == 1
    ev, r_ev = out["eval"][0], r_out["eval"][0]
    assert ev["epoch"] == r_ev["epoch"] == EPOCH0
    names = sorted(r_ev["bn"])
    assert sorted(ev["bn"]) == names and names
    for i, what in enumerate(("mean", "var")):
        assert_close(f"{case}: sBN {what} (all sites)",
                     np.concatenate([np.asarray(ev["bn"][n][i]) for n in names]),
                     np.concatenate([np.asarray(r_ev["bn"][n][i]) for n in names]),
                     rtol=1e-4, atol=1e-5)
    for part in ("local", "global"):
        assert_close(f"{case}: {part} n", ev[part]["n"], r_ev[part]["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"{case}: {part} {name}", ev[part][name], r_ev[part][name],
                         rtol=1e-4, atol=1e-4)
