"""``dynamic`` rates of the PyTorch/CUDA port, and the two faults repaired
beside them, against the JAX reference on the CPU: the processed cfg; one
round with the reference's drawn rates handed in, against
``RoundEngine.train_round``; a statistical contract on the port's own draw;
the entry point in dynamic mode with a resume; the width-geometry check;
and a round of zero clients (``frac`` 0)."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_round import (assert_round_matches, reference_draws,
                                   run_reference_round)

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import label_split_masks as r_lsm
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.data import stack_client_shards as r_stack
from heterofl_tpu.entry import train_classifier_fed as r_train_fed
from heterofl_tpu.fed.core import round_rates as r_round_rates
from heterofl_tpu.fed.core import validate_width_geometry as r_validate
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.entry import (test_classifier_fed, train_classifier_fed,
                                      train_transformer_fed)
from heterofl_tpu_torch.entry.common import FedExperiment, round_seed
from heterofl_tpu_torch.fed import round_rates, validate_width_geometry
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.utils import checkpoint as ckpt
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

PORT_KEYS = ("model_rate", "proportion", "model_split_mode", "global_model_rate",
             "global_model_mode", "num_users", "frac", "norm", "model_mode", "control_name")


@pytest.mark.parametrize("control", ["1_100_0.1_iid_dynamic_a1-b1-c1-d1-e1_bn_1_1",
                                     "1_10_0.5_non-iid-2_dynamic_a2-e8_gn_1_1",
                                     "1_100_0.1_iid_dynamic_b1-d3_ln_0_1"])
def test_process_control_dynamic_matches_reference(control):
    out = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name(control)
        cfg["data_name"], cfg["model_name"] = "CIFAR10", "resnet18"
        out.append(mod.process_control(cfg))
    ref, port = out
    for k in PORT_KEYS:
        assert port[k] == ref[k], k


def _conv_cfg(mod, control="1_4_1_iid_dynamic_a1-b1-c1-e2_bn_1_1"):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(control)
    cfg["data_name"], cfg["model_name"] = "MNIST", "conv"
    cfg["override"] = {"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}}
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def test_dynamic_round_with_reference_rates_matches_reference():
    """A dynamic round of 4 users: the reference draws their rates inside
    its round (``round_rates`` at the round key); handed the same rates and
    epoch permutations, the port's ``RoundEngine.train_round`` of the
    dynamic cfg gives the reference's new params and sums at the round's
    stated tolerance (atol 5e-5 on params), and reports those rates."""
    ds = r_fetch("MNIST", synthetic=True, seed=0, synthetic_sizes={"train": 160, "test": 20})
    split, lsplit = r_split(ds, 4, "iid", np.random.default_rng(0), classes_size=10)
    arrays = r_stack(ds["train"].data, ds["train"].target, split["train"], list(range(4))) + \
        (r_lsm(lsplit, 4, 10),)
    users = np.array([3, 0, 2, 1])
    rcfg = _conv_cfg(RC)
    rates = np.asarray(r_round_rates(jax.random.key(3), rcfg, jnp.asarray(users)))
    assert len(set(rates.tolist())) > 1  # a mix of levels
    params_np, r_new, r_ms = run_reference_round(rcfg, arrays, users)
    np.testing.assert_array_equal(r_ms["rate"], rates)
    perms, _ = reference_draws(jax.random.key(3), users, 1, arrays[0].shape[1])
    assert_round_matches("dynamic round, the reference's rates", params_np, _conv_cfg(PC),
                         arrays, users, r_new, r_ms, epoch_perms=perms, rates=rates)


def test_dynamic_draw_meets_its_statistical_contract():
    """The port's own draw (``round_rates``) over 400 rounds of 100 users at
    proportions 1:2:3:1:3 of levels a-e: the level counts' chi-square
    statistic against ``proportion`` is below 18.47, the 0.999 quantile of
    chi-square at 4 degrees of freedom; every round re-rolls (consecutive
    rounds differ); a round's draw depends on its seed alone (drawn again,
    equal), and the cohort's rates are the population draw at its users."""
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_100_0.1_iid_dynamic_a1-b2-c3-d1-e3_bn_1_1")
    cfg = PC.process_control(cfg)
    p = np.asarray(cfg["proportion"])
    levels = np.asarray(cfg["model_rate"], np.float32)
    draws = np.stack([round_rates(seed, cfg) for seed in range(400)])
    counts = np.array([(draws == r).sum() for r in levels])
    assert counts.sum() == draws.size
    expected = draws.size * p
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    print(f"parity dynamic draw: chi-square {chi2:.3f} over {draws.size} draws, counts "
          f"{counts.tolist()} against {expected.tolist()} (bound 18.47, 4 dof, p 0.001)")
    assert chi2 < 18.47
    assert all((draws[i] != draws[i + 1]).any() for i in range(len(draws) - 1))
    np.testing.assert_array_equal(round_rates(17, cfg), draws[17])
    users = np.array([5, 99, 0, 42])
    np.testing.assert_array_equal(round_rates(17, cfg, users), draws[17][users])


SIZES = '{"train": 200, "test": 40}'
DYN = "1_4_0.5_iid_dynamic_a1-e1_gn_1_1"
COHORTS = {1: [0, 3], 2: [2, 1], 3: [3, 1]}


def _argv(out, rounds, control=DYN, *extra, port=True):
    argv = ["--output_dir", str(out), "--control_name", control, "--data_name", "MNIST",
            "--model_name", "conv", "--synthetic", "1", "--synthetic_sizes", SIZES,
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1},
                                      "conv": {"hidden_size": [8, 16]}}), *extra]
    return argv + (["--device", "cpu"] if port else ["--sampler", "perm"])


def test_dynamic_entry_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """``train_classifier_fed --device cpu`` in dynamic mode (gn): three
    rounds in one run, against two rounds, a checkpoint and a resumed
    third (the cohort pinned per round: a resumed run restarts the numpy
    stream) -- equal params bit for bit, equal logs; ``test_classifier_fed``
    on the best checkpoint reproduces the logged accuracy; every round's
    rates come from the mode set and are the population draw at its
    seed."""
    monkeypatch.setattr(FedExperiment, "sample_users",
                        lambda self, epoch: np.array(COHORTS[epoch], np.int64))
    (full,) = train_classifier_fed.main(_argv(tmp_path / "full", 3))
    train_classifier_fed.main(_argv(tmp_path / "cut", 2))
    (res,) = train_classifier_fed.main(_argv(tmp_path / "cut", 3, DYN, "--resume_mode", "1"))
    assert [r["epoch"] for r in res["history"]] == [3]
    for k, v in full["params"].items():
        assert torch.equal(res["params"][k], v), k
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    assert hist(res) == hist(full) and len(hist(full)["train/Local-Loss"]) == 3
    assert res["history"][0]["user_rates"] == full["history"][2]["user_rates"]
    (out,) = test_classifier_fed.main(_argv(tmp_path / "full", 3))
    best = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "full"),
                                                     f"0_MNIST_label_conv_{DYN}", "best"))
    assert out["logger_history"]["test/Global-Accuracy"][0] == \
        best["logger_history"]["test/Global-Accuracy"][-1]
    cfg = PC.process_control(dict(PC.default_cfg(), control=PC.parse_control_name(DYN)))
    for rec in full["history"]:
        assert set(rec["user_rates"]) <= {1.0, 0.0625} and rec["users"] == COHORTS[rec["epoch"]]
        want = round_rates(round_seed(0, rec["epoch"]), cfg, rec["users"])
        assert rec["user_rates"] == want.tolist()
        assert math.isfinite(rec["loss"])


# --- the width-geometry check (a transformer's per-head slice) -------------------------

def _lm_cfgs(embedding, heads, mode="a1-b1-c1-d1-e1"):
    out = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name(f"1_10_1_iid_fix_{mode}_bn_1_1")
        cfg["data_name"], cfg["model_name"] = "WikiText2", "transformer"
        cfg["override"] = {"transformer": {"embedding_size": embedding, "num_heads": heads,
                                           "hidden_size": 64, "num_layers": 1, "dropout": 0.0}}
        cfg = mod.process_control(cfg)
        cfg["num_tokens"] = cfg["classes_size"] = 50
        out.append(cfg)
    return out


@pytest.mark.parametrize("embedding,heads,mode,refused", [
    (32, 4, "a1", False), (32, 4, "a1-b1", False), (32, 4, "a1-c1", False),
    (32, 4, "a1-d1", False), (32, 4, "a1-e1", True), (32, 4, "e1", True),
    (32, 4, "a1-b1-c1-d1-e1", True),
    (256, 8, "a1-b1-c1-d1-e1", False)])
def test_width_geometry_refused_exactly_where_the_reference_refuses(embedding, heads, mode,
                                                                     refused):
    """E 32 with 4 heads keeps 8 dims a head: level e keeps one dim a head
    (4 in all) where the width slice keeps 2, so every config with level e
    is refused; E 256 with 8 heads is consistent at every level.  Both packages refuse the same
    configs, with the same message."""
    rcfg, pcfg = _lm_cfgs(embedding, heads, mode)
    msgs = []
    for validate, model in ((r_validate, r_make_model(rcfg)), (validate_width_geometry,
                                                               make_model(pcfg))):
        try:
            validate(model, rcfg if validate is r_validate else pcfg)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[1] is not None) == refused
    if refused:
        assert msgs[1].startswith("width geometry: group")


def test_inconsistent_transformer_is_refused_before_any_round(tmp_path):
    """The control ``1_4_1_iid_fix_a1-e1_bn_1_1`` on synthetic WikiText2
    with E 32 and 4 heads raises the reference's ``ValueError`` at
    construction; no round runs and no checkpoint is written (it used to
    train NaN and checkpoint it)."""
    argv = ["--device", "cpu", "--control_name", "1_4_1_iid_fix_a1-e1_bn_1_1", "--synthetic",
            "1", "--synthetic_sizes", '{"train": 2000, "test": 400}', "--output_dir",
            str(tmp_path), "--override", json.dumps(
                {"num_epochs": {"global": 1, "local": 1}, "bptt": 16,
                 "transformer": {"embedding_size": 32, "num_heads": 4, "hidden_size": 64,
                                 "num_layers": 1, "dropout": 0.2}})]
    with pytest.raises(ValueError, match=r"width geometry: group .* \(size 32, 4 heads\) is "
                                         r"inconsistent at rate 0.0625"):
        train_transformer_fed.main(argv)
    assert not os.path.exists(tmp_path / "model")


# --- frac 0: a round of no clients -------------------------------------------------------

def test_zero_client_round_leaves_params_and_logs_like_reference(tmp_path):
    """``frac`` 0 draws no client: the round leaves every parameter at its
    initial value (the stale-value fallback), logs ``Rates: []``, and still
    evaluates and checkpoints; the log's keys are the reference's run's."""
    control = "1_4_0_iid_fix_a1-e1_bn_1_1"
    (res,) = train_classifier_fed.main(_argv(tmp_path / "port", 1, control))
    r_train_fed.main(_argv(tmp_path / "ref", 1, control, port=False))
    tag = f"0_MNIST_label_conv_{control}"
    port_blob = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "port"), tag))
    ref_blob = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "ref"), tag))
    init = make_model(dict(PC.process_control(dict(
        PC.default_cfg(), control=PC.parse_control_name(control), data_name="MNIST",
        model_name="conv", override={"conv": {"hidden_size": [8, 16]}})), classes_size=10,
        data_shape=[28, 28, 1])).init_(torch.Generator().manual_seed(0))
    for k, v in init.params().items():
        assert torch.equal(res["params"][k], v.detach()), k
    (rec,) = res["history"]
    assert rec["rates"] == [] and rec["users"] == [] and rec["n"] == 0.0
    assert sorted(port_blob["logger_history"]) == sorted(ref_blob["logger_history"])
    assert "test/Global-Accuracy" in port_blob["logger_history"]
    assert port_blob["epoch"] == ref_blob["epoch"] == 2
