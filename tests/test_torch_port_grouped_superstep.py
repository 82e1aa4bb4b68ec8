"""The grouped engine's compressed superstep of the PyTorch/CUDA port
against the JAX reference's ``GroupedRoundEngine.train_superstep`` on the
CPU (``make_mesh(1, 1)``, span layout): the reference compresses a grouped
round only in its superstep (``heterofl_tpu/entry/common.py:325-335``), so
its superstep is what defines this computation.

Two rounds as one superstep with the int8 codec and error feedback, from
the same params, ``[k, A]`` user and rate schedules and learning rate,
with the reference's client draws (``reference_draws`` at each round's key
``fold_in(base_key, epoch0 + r)``: the grouped clients draw from the
masked engine's client keys) and its codec noise
(``uniform(fold_in(fold_in(key_r, 9173), 0), (total,))``, the draw inside
its ``shard_map``) handed in.  The schedule puts two clients at level a in
round 1 and two at level e in round 2, so the codec's grid is sized for
3 levels x 2 slots = 6 clients, not the 4 that train.

Contract, as the masked engine's two int8 rounds against the reference's
(tests/test_torch_port_compress.py): the trained sums differ by float32
reduction order, so a few entries land one grid step apart.  After the
second round (each side from its own first round) params agree within
5e-5 everywhere but at most 2% of entries, each at most one step
``s_leaf / count`` (+5e-5) apart; the residual within 4 x 5e-5 but at most
2% of entries, each at most one step ``s_leaf`` (+2e-4) apart.  Per-round
metric sums at the grouped round's tolerance (rtol/atol 1e-4), ``n`` and
rates exactly."""

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
from heterofl_tpu_torch.compress.codecs import QUANT_NOISE_SALT
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import GroupedRoundEngine
from heterofl_tpu_torch.testing import assert_close, assert_grid_close, thread_limit_fixture
from test_torch_port_grouped import _vision_data
from test_torch_port_round import reference_draws

CONTROL = "1_6_1_iid_fix_a2-c2-e2_bn_1_1"  # users 0, 1 at level a; 2, 3 at c; 4, 5 at e
USERS = np.array([[0, 1, 2, 4], [3, 4, 5, 0]])  # [k, A]: level a twice, then level e twice
LR, EPOCH0 = 0.05, 3

few_threads = thread_limit_fixture()


def _cfg(mod):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", pallas_norm=False, wire_codec="int8",
               error_feedback=True, strategy="grouped", superstep_rounds=2,
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}})
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


@pytest.fixture(scope="module")
def supersteps():
    """Both supersteps from the reference's init: (reference params, metric
    rounds and residual; the port's; the port's grid steps of round 2)."""
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
    r_flat_spec = RFlatSpec({n: v.shape for n, v in params.items()})
    r_flat = np.asarray(r_flat_spec.flatten({n: jnp.asarray(v) for n, v in r_new.items()}))
    r_resid = np.asarray(reng.wire_resid_host())

    model = make_model(pcfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(params, perms))
    eng = GroupedRoundEngine(model, pcfg, torch.device("cpu"))
    spec = eng.spec

    def to_port(ref_flat):  # reference flat layout -> the port's
        leaves = {n: np.asarray(v) for n, v in r_flat_spec.unflatten(jnp.asarray(ref_flat)).items()}
        return spec.flatten(params_from_jax(leaves, perms))

    keys = [jax.random.fold_in(base_key, EPOCH0 + r) for r in range(k)]
    draws = [reference_draws(key, USERS[r], E, N)[0] for r, key in enumerate(keys)]
    noise = [to_port(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, QUANT_NOISE_SALT), 0), (r_flat_spec.total,),
        jnp.float32))) for key in keys]
    data = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    P0 = eng.flatten(model.params())
    cmax = eng.codec_slots(rates)
    assert cmax == 6, cmax
    # round 1 alone through the engine's round body on the superstep's grid:
    # the params that size round 2's grid step
    P1, _ = eng._train_round(P0.clone(), LR, USERS[0], data, 0, draws[0], None, rates[0], None,
                             codec_noise=noise[0], codec_slots=cmax)
    eng.reset_carries()
    P2, pending = eng.train_superstep(P0.clone(), 0, EPOCH0, k, data, USERS, rates, [LR] * k,
                                      epoch_perms=draws, codec_noise=noise)
    counts = torch.zeros_like(P0)
    for u, rate in zip(USERS[1], rates[1]):
        lv = eng.levels[float(rate)]
        counts.index_add_(0, lv.idx, lv.count_masks(data[-1][[int(u)]])[0])
    s = eng.codec.scale_flat(P1, cmax)
    return {"ref": (to_port(r_flat), r_rounds, to_port(r_resid.reshape(-1, r_flat_spec.total)[0])),
            "port": (P2, pending.fetch(), eng.wire_resid_host()),
            "step": (torch.where(counts > 0, s / counts.clamp_min(1), 0.0), s), "A": USERS.shape[1]}


def test_grouped_int8_superstep_params_and_residual_match_reference(supersteps):
    """Params and the error-feedback residual after the two rounds."""
    r_P, _, r_resid = supersteps["ref"]
    P, _, resid = supersteps["port"]
    step, s = supersteps["step"]
    assert resid.shape == (1, r_P.numel())
    assert_grid_close("grouped int8 superstep: params after 2 rounds", P, r_P, step, atol=5e-5,
                      max_share=0.02)
    assert_grid_close("grouped int8 superstep: residual", resid[0], r_resid, s,
                      atol=5e-5 * supersteps["A"], max_share=0.02)
    assert bool(np.any(resid != 0))


def test_grouped_int8_superstep_metrics_match_reference(supersteps):
    """Each round's per-client metric sums, in slot order."""
    _, r_rounds, _ = supersteps["ref"]
    _, rounds, _ = supersteps["port"]
    assert len(rounds) == len(r_rounds) == USERS.shape[0]
    for r, (ms, r_ms) in enumerate(zip(rounds, r_rounds), start=1):
        assert_close(f"grouped int8 superstep round {r}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
        for name in ("loss_sum", "score_sum"):
            assert_close(f"grouped int8 superstep round {r}: {name}", ms[name], r_ms[name],
                         rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ms["rate"], np.asarray(r_ms["rate"]))
