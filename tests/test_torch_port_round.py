"""One federated round of the PyTorch/CUDA port against the JAX reference's
``RoundEngine.train_round`` on the CPU (MNIST conv twin: same initial
params, users and fix rates, the reference's epoch permutations injected),
and the port's entry point end to end on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import label_split_masks as r_lsm
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.data import stack_client_shards as r_stack
from heterofl_tpu.fed.core import client_stream_keys
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.parallel import RoundEngine as RRoundEngine
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.entry import train_classifier_fed
from heterofl_tpu_torch.entry.common import FedExperiment
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.parallel import RoundEngine
from heterofl_tpu_torch.testing import assert_close

CONTROL = "1_4_1_iid_fix_a1-b1-c1-e1_bn_1_1"  # rates 1, 0.5, 0.25, 0.0625
OVERRIDE = {"num_epochs": {"local": 2}, "conv": {"hidden_size": [8, 16]}}
LR = 0.05


def _cfg(mod, pallas=False):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg["data_name"], cfg["model_name"] = "MNIST", "conv"
    cfg["pallas_norm"] = pallas
    cfg["override"] = OVERRIDE
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def _data():
    ds = r_fetch("MNIST", synthetic=True, seed=0, synthetic_sizes={"train": 400, "test": 40})
    split, lsplit = r_split(ds, 4, "iid", np.random.default_rng(0), classes_size=10)
    # user 1 holds 75 of 100: a half-padding batch and two all-padding batches
    split["train"][1] = split["train"][1][:75]
    x, y, m = r_stack(ds["train"].data, ds["train"].target, split["train"], [0, 1, 2, 3])
    return x, y, m, r_lsm(lsplit, 4, 10)


@pytest.fixture(scope="module")
def reference_round():
    """One ``RoundEngine.train_round`` of the reference, its initial params,
    and the epoch permutations it drew (round_engine.py:659-670), per user."""
    rcfg = _cfg(RC)
    x, y, m, lm = _data()
    rmodel = r_make_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    # the reference round donates its params: keep a host copy for the port
    params_np = {k: np.asarray(v) for k, v in params.items()}
    key, users = jax.random.key(3), np.array([0, 1, 2, 3])
    eng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
    r_new, r_ms = eng.train_round(params, key, LR, users,
                                  tuple(jnp.asarray(a) for a in (x, y, m, lm)))
    E, N = rcfg["num_epochs"]["local"], x.shape[1]
    slot_keys = client_stream_keys(key, jnp.asarray(users))
    perms = {}
    for i, u in enumerate(users):
        ekeys = jax.random.split(jax.random.fold_in(slot_keys[i], 1), E)
        perms[int(u)] = np.stack([np.asarray(jax.random.permutation(k, N)) for k in ekeys])
    return (params_np, users, perms, (x, y, m, lm),
            {k: np.asarray(v) for k, v in r_new.items()},
            {k: np.asarray(v) for k, v in r_ms.items()})


@pytest.mark.parametrize("fused_update", [True, False])
def test_round_matches_reference_round_engine(reference_round, fused_update):
    """From the reference's params, users, fix rates and epoch permutations,
    the port's round (fused-SGD plain version, or the per-leaf chain) gives
    the new global params to atol 5e-5 (float32 convs/reductions in another
    order, compounded over 20 local SGD steps), per-client metric sums to
    rtol/atol 1e-4, ``n`` exactly."""
    params_np, users, perms, arrays, r_new, r_ms = reference_round
    pcfg = dict(_cfg(PC), fused_update=fused_update)
    E = pcfg["num_epochs"]["local"]
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params_np))
    peng = RoundEngine(model, pcfg, torch.device("cpu"))
    data = tuple(torch.from_numpy(a) for a in arrays)
    new, ms = peng.train_round(peng.flatten(model.params()), LR, users, data, round_seed=0,
                               epoch_perms=perms)
    p_new = params_to_jax(peng.unflatten(new))
    assert set(p_new) == set(r_new)
    names = sorted(r_new)
    case = f"one round (fused_update={fused_update})"
    assert_close(f"{case}: new global params",
                 np.concatenate([p_new[k].ravel() for k in names]),
                 np.concatenate([r_new[k].ravel() for k in names]), rtol=0, atol=5e-5)
    assert_close(f"{case}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
    assert ms["n"][1].item() == 75.0 * E
    for k in ("loss_sum", "score_sum"):
        assert_close(f"{case}: {k}", ms[k], r_ms[k], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ms["rate"], r_ms["rate"])


def test_experiment_cohorts_follow_reference_numpy_stream():
    """The split and then the per-round user permutations come from ONE
    ``default_rng(seed)`` stream, consumed in the reference experiment loop's
    order."""
    cfg = _cfg(PC)
    cfg.update(device="cpu", synthetic=True, synthetic_sizes={"train": 200, "test": 40},
               frac=0.5)
    exp = FedExperiment(cfg, seed=7)
    split, lsplit = exp.make_splits()
    cohorts = [exp.sample_users(e) for e in (1, 2, 3)]
    rng = np.random.default_rng(7)
    ds = r_fetch("MNIST", synthetic=True, seed=7, synthetic_sizes={"train": 200, "test": 40})
    r_ds, r_ls = r_split(ds, 4, "iid", rng, classes_size=10)
    assert split == r_ds and dict(lsplit) == dict(r_ls)
    for c in cohorts:
        np.testing.assert_array_equal(c, rng.permutation(4)[:2])


def _argv(out_dir, extra=()):
    return ["--output_dir", str(out_dir),
            "--control_name", "1_4_0.5_iid_fix_a1-e1_bn_1_1", "--data_name", "MNIST",
            "--model_name", "conv", "--synthetic", "1", "--pallas_norm", "1",
            "--synthetic_sizes", '{"train": 200, "test": 40}',
            "--override", '{"num_epochs": {"global": 2, "local": 1}, '
                          '"conv": {"hidden_size": [8, 16]}}', *extra]


def test_entry_runs_two_rounds_on_cpu(tmp_path):
    """``--device cpu``: two finite rounds through the port's entry point;
    the new params are finite and at the model's shapes."""
    (res,) = train_classifier_fed.main(_argv(tmp_path, ["--device", "cpu"]))
    hist = res["history"]
    assert [r["epoch"] for r in hist] == [1, 2]
    assert all(math.isfinite(r["loss"]) and r["n"] > 0 for r in hist)
    assert all(torch.isfinite(v).all() for v in res["params"].values())
    assert res["params"]["block0.conv.w"].shape == (8, 1, 3, 3)


def test_entry_raises_without_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        train_classifier_fed.main(_argv(tmp_path))
