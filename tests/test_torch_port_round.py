"""One federated round of the PyTorch/CUDA port against the JAX reference's
``RoundEngine.train_round`` on the CPU (MNIST conv twin, and ResNet-18 with
CIFAR augmentation: same initial params, users and fix rates, the
reference's epoch permutations and augmentation draws injected), and the
port's entry point end to end on the CPU.  The round harness here
(:func:`reference_draws`, :func:`run_reference_round`,
:func:`assert_round_matches`) also serves the dynamic-rate and norm rounds
(``tests/test_torch_port_dynamic.py``, ``tests/test_torch_port_norms.py``)."""

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
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture

few_threads = thread_limit_fixture()

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


def reference_draws(key, users, E, N, B=None, steps=0):
    """The per-client draws of a reference round at ``key``
    (round_engine.py:659-703): each user's raw epoch permutations ``[E,
    N]`` and, for ``steps`` local steps of batch ``B``, its CIFAR
    augmentation draws (``augment_cifar``'s crop offsets and flips), as the
    port's ``epoch_perms`` and ``aug_draws`` hooks take them."""
    slot_keys = client_stream_keys(key, jnp.asarray(users))
    perms, aug = {}, {}
    for i, u in enumerate(np.asarray(users).tolist()):
        ekeys = jax.random.split(jax.random.fold_in(slot_keys[i], 1), E)
        perms[u] = np.stack([np.asarray(jax.random.permutation(k, N)) for k in ekeys])
        for t in range(steps):
            k_shift, k_flip = jax.random.split(jax.random.fold_in(slot_keys[i], 2 + t))
            aug[u, t] = (np.asarray(jax.random.randint(k_shift, (B, 2), 0, 9)),
                         np.asarray(jax.random.bernoulli(k_flip, 0.5, (B,))))
    return perms, (lambda u, t: aug[u, t])


def run_reference_round(rcfg, arrays, users, key=3, lr=LR):
    """One ``RoundEngine.train_round`` of the reference from its own init
    (key 0) -> (initial params, new params, metric sums), host arrays."""
    rmodel = r_make_model(rcfg)
    params = rmodel.init(jax.random.key(0))
    # the reference round donates its params: keep a host copy for the port
    params_np = {k: np.asarray(v) for k, v in params.items()}
    eng = RRoundEngine(rmodel, rcfg, make_mesh(1, 1))
    r_new, r_ms = eng.train_round(params, jax.random.key(key), lr, np.asarray(users),
                                  tuple(jnp.asarray(a) for a in arrays))
    return (params_np, {k: np.asarray(v) for k, v in r_new.items()},
            {k: np.asarray(v) for k, v in r_ms.items()})


def assert_round_matches(case, params_np, pcfg, arrays, users, r_new, r_ms, **hooks):
    """The port's round from the reference's params, with the reference's
    draws handed in through ``hooks``: the new global params to atol 5e-5,
    the per-client metric sums to rtol/atol 1e-4, ``n`` and the rates
    exactly -> the port's metric sums."""
    model = make_model(pcfg)
    model.load_state_dict(params_from_jax(params_np))
    peng = RoundEngine(model, pcfg, torch.device("cpu"))
    data = tuple(torch.from_numpy(a) for a in arrays)
    new, ms = peng.train_round(peng.flatten(model.params()), LR, users, data, round_seed=0,
                               **hooks)
    p_new = params_to_jax(peng.unflatten(new))
    assert set(p_new) == set(r_new)
    names = sorted(r_new)
    assert_close(f"{case}: new global params",
                 np.concatenate([p_new[k].ravel() for k in names]),
                 np.concatenate([r_new[k].ravel() for k in names]), rtol=0, atol=5e-5)
    assert_close(f"{case}: n", ms["n"], r_ms["n"], rtol=0, atol=0)
    for k in ("loss_sum", "score_sum"):
        assert_close(f"{case}: {k}", ms[k], r_ms[k], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ms["rate"], r_ms["rate"])
    return ms


@pytest.fixture(scope="module")
def reference_round():
    """One ``RoundEngine.train_round`` of the reference, its initial params,
    and the epoch permutations it drew, per user."""
    rcfg = _cfg(RC)
    arrays = _data()
    users = np.array([0, 1, 2, 3])
    params_np, r_new, r_ms = run_reference_round(rcfg, arrays, users)
    perms, _ = reference_draws(jax.random.key(3), users, rcfg["num_epochs"]["local"],
                               arrays[0].shape[1])
    return params_np, users, perms, arrays, r_new, r_ms


@pytest.mark.parametrize("fused_update", [True, False])
def test_round_matches_reference_round_engine(reference_round, fused_update):
    """From the reference's params, users, fix rates and epoch permutations,
    the port's round (fused-SGD plain version, or the per-leaf chain) gives
    the new global params to atol 5e-5 (float32 convs/reductions in another
    order, compounded over 20 local SGD steps), per-client metric sums to
    rtol/atol 1e-4, ``n`` exactly."""
    params_np, users, perms, arrays, r_new, r_ms = reference_round
    pcfg = dict(_cfg(PC), fused_update=fused_update)
    ms = assert_round_matches(f"one round (fused_update={fused_update})", params_np, pcfg,
                              arrays, users, r_new, r_ms, epoch_perms=perms)
    assert ms["n"][1].item() == 75.0 * pcfg["num_epochs"]["local"]


def _resnet_cfg(mod):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name("1_2_1_iid_fix_a1-e1_bn_1_1")
    cfg["data_name"], cfg["model_name"] = "CIFAR10", "resnet18"
    cfg["override"] = {"num_epochs": {"local": 1}, "resnet": {"hidden_size": [8, 16, 16, 16]}}
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def test_resnet18_round_with_augmentation_matches_reference():
    """A ResNet-18 round (widths 8/16/16/16) of a level-a and a level-e
    client, 2 local steps each, CIFAR augmentation on: with the reference's
    epoch permutations and crop/flip draws handed in through the round's
    hooks, the port's round equals ``RoundEngine.train_round`` at the
    round's stated tolerance (atol 5e-5 on params; metric sums 1e-4).
    Longer level-e rounds drift apart by float rounding alone (chaos)."""
    ds = r_fetch("CIFAR10", synthetic=True, seed=0, synthetic_sizes={"train": 40, "test": 10})
    split, lsplit = r_split(ds, 2, "iid", np.random.default_rng(0), classes_size=10)
    arrays = r_stack(ds["train"].data, ds["train"].target, split["train"], [0, 1]) + \
        (r_lsm(lsplit, 2, 10),)
    users = np.array([0, 1])
    rcfg = _resnet_cfg(RC)
    B, N = rcfg["batch_size"]["train"], arrays[0].shape[1]
    steps = math.ceil(N / B)
    assert steps == 2
    params_np, r_new, r_ms = run_reference_round(rcfg, arrays, users)
    perms, aug = reference_draws(jax.random.key(3), users, 1, N, B, steps)
    assert_round_matches("ResNet-18 round, augmentation on", params_np, _resnet_cfg(PC),
                         arrays, users, r_new, r_ms, epoch_perms=perms, aug_draws=aug)


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
