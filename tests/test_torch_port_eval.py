"""Evaluation of the PyTorch/CUDA port against the JAX reference on the CPU:
``batch_norm``'s ``running`` and ``collect`` modes, the evaluator's sBN
statistics and Local/Global metric sums against the reference
``Evaluator`` on ``make_mesh(1, 1)`` (MNIST conv twin and ResNet-18 at
hidden 8/16/16/16, from converted params), and the entry point with the
int8 codec and evaluation, end to end on the CPU."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.entry.common import stage_eval_operands as r_stage_eval_operands
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.ops import layers as r_layers
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu.parallel.evaluation import Evaluator as REvaluator
from heterofl_tpu.utils.metrics import summarize_sums as r_summarize_sums
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax
from heterofl_tpu_torch.data import fetch_dataset, label_split_masks, split_dataset
from heterofl_tpu_torch.entry import train_classifier_fed
from heterofl_tpu_torch.entry.common import FedExperiment, stage_eval_operands
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.ops import layers
from heterofl_tpu_torch.parallel import Evaluator
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from heterofl_tpu_torch.utils import summarize_sums

few_threads = thread_limit_fixture()

HIDDEN = {"conv": {"conv": {"hidden_size": [8, 16]}},
          "resnet18": {"resnet": {"hidden_size": [8, 16, 16, 16]}}}
DATA = {"conv": "MNIST", "resnet18": "CIFAR10"}
USERS = 5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# --- batch norm modes ----------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["running", "collect"])
def test_batch_norm_modes_match_reference(mode, weighted):
    """``batch_norm(mode=...)`` against the reference's: ``running``
    normalises with given statistics, ``collect`` also returns the mean and
    the unbiased variance ``var * n / max(n - 1, 1)`` (``n`` the weighted
    count).  rtol/atol 1e-5 (reductions in another order)."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(6, 5, 5, 16)) * 2 + 0.5).astype(np.float32)
    g, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    w = np.array([1, 1, 0, 1, 1, 0], np.float32) if weighted else None
    run = (rng.normal(size=16).astype(np.float32), rng.uniform(0.5, 2, 16).astype(np.float32))
    kw = {"running": run} if mode == "running" else {}
    y_r, st_r = r_layers.batch_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), mode=mode,
                                    sample_weight=None if w is None else jnp.asarray(w),
                                    **{k: tuple(map(jnp.asarray, v)) for k, v in kw.items()})
    y, st = layers.batch_norm(_nchw(x), torch.from_numpy(g), torch.from_numpy(b),
                              sample_weight=None if w is None else torch.from_numpy(w), mode=mode,
                              **{k: tuple(map(torch.from_numpy, v)) for k, v in kw.items()})
    case = f"batch_norm {mode} (weighted={weighted})"
    assert_close(f"{case}: y", _nhwc(y), y_r, rtol=1e-5, atol=1e-5)
    if mode == "collect":
        assert_close(f"{case}: mean", st[0], st_r[0], rtol=1e-5, atol=1e-5)
        assert_close(f"{case}: unbiased var", st[1], st_r[1], rtol=1e-5, atol=1e-5)
    else:
        assert st is None and st_r is None


# --- the evaluator ------------------------------------------------------------

def _cfg(mod, model_name):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(f"1_{USERS}_1_non-iid-2_fix_a1-e1_bn_1_1")
    cfg["data_name"], cfg["model_name"] = DATA[model_name], model_name
    cfg["override"] = {**HIDDEN[model_name], "batch_size": {"train": 10, "test": 10}}
    cfg = mod.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


@pytest.fixture(scope="module")
def eval_runs():
    """Per model: the reference evaluator's sBN statistics and Local and
    Global sums, and the port's, from the same perturbed params and the same
    eval operands (55 train images -> 6 sBN batches, the last half padding;
    40 test images over 5 non-iid users)."""
    cache = {}

    def get(model_name):
        if model_name in cache:
            return cache[model_name]
        rcfg, pcfg = _cfg(RC, model_name), _cfg(PC, model_name)
        ds = fetch_dataset(pcfg["data_name"], synthetic=True, seed=1,
                           synthetic_sizes={"train": 55, "test": 40})
        split, lsplit = split_dataset(ds, USERS, "non-iid-2", np.random.default_rng(0),
                                      classes_size=10)
        lm = label_split_masks(lsplit, USERS, 10)
        ops = stage_eval_operands(pcfg, ds["train"], ds["test"], split["test"], lm)
        r_ops = r_stage_eval_operands(rcfg, ds["train"], ds["test"], split["test"], lm)
        for a, b in zip(jax.tree_util.tree_leaves(ops), jax.tree_util.tree_leaves(r_ops)):
            np.testing.assert_array_equal(a, b)
        (xb, wb), local, glob = ops
        rmodel = r_make_model(rcfg)
        rng = np.random.default_rng(7)
        params = {k: np.asarray(v) + rng.normal(0, 0.05, v.shape).astype(np.float32)
                  for k, v in rmodel.init(jax.random.key(0)).items()}
        rev = REvaluator(rmodel, rcfg, make_mesh(1, 1))
        r_bn = rev.sbn_stats(params, xb, wb)
        ref = {"bn": {k: tuple(np.asarray(a) for a in v) for k, v in r_bn.items()},
               "local": rev.eval_users(params, r_bn, *local),
               "global": rev.eval_global(params, r_bn, *glob)}
        model = make_model(pcfg)
        model.load_state_dict(params_from_jax(params))
        ev = Evaluator(model, pcfg, torch.device("cpu"))
        p = model.params()
        t = torch.from_numpy
        bn = ev.sbn_stats(p, t(xb), t(wb))
        port = {"bn": bn, "local": ev.eval_users(p, bn, *map(t, local)),
                "global": ev.eval_global(p, bn, *map(t, glob))}
        cache[model_name] = (ref, port, local[2])
        return cache[model_name]

    return get


@pytest.mark.parametrize("model_name", ["conv", "resnet18"])
def test_sbn_stats_match_reference(eval_runs, model_name):
    """Every BN site's cumulative-average (mean, var) over the sBN batches:
    rtol 1e-4, atol 1e-5 (float32 convolutions and reductions in another
    order, through the network's depth)."""
    ref, port, _ = eval_runs(model_name)
    assert sorted(port["bn"]) == sorted(ref["bn"]) and port["bn"]
    names = sorted(ref["bn"])
    for i, what in enumerate(("mean", "var")):
        assert_close(f"sBN {model_name}: {what} (all sites)",
                     np.concatenate([port["bn"][k][i].numpy() for k in names]),
                     np.concatenate([ref["bn"][k][i] for k in names]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model_name", ["conv", "resnet18"])
def test_local_eval_matches_reference(eval_runs, model_name):
    """Per-user Local sums under each user's label mask, from each side's
    own sBN statistics: ``loss_sum`` rtol 1e-4, atol 1e-4; the correct
    counts and ``n`` exactly; the named metrics agree."""
    ref, port, m = eval_runs(model_name)
    case = f"Local {model_name}"
    assert_close(f"{case}: loss_sum", port["local"]["loss_sum"], ref["local"]["loss_sum"],
                 rtol=1e-4, atol=1e-4)
    for k in ("score_sum", "n"):
        assert_close(f"{case}: {k}", port["local"][k], ref["local"][k], rtol=0, atol=0)
    np.testing.assert_array_equal(port["local"]["n"], m.sum((1, 2)))
    named, r_named = summarize_sums(port["local"]), r_summarize_sums(ref["local"], model_name)
    assert sorted(named) == sorted(r_named) == ["Local-Accuracy", "Local-Loss"]
    assert named["Local-Accuracy"] == r_named["Local-Accuracy"]


@pytest.mark.parametrize("model_name", ["conv", "resnet18"])
def test_global_eval_matches_reference(eval_runs, model_name):
    """Global sums over the whole test set: ``loss_sum`` rtol 1e-4, the
    correct count and ``n`` exactly."""
    ref, port, _ = eval_runs(model_name)
    case = f"Global {model_name}"
    assert_close(f"{case}: loss_sum", port["global"]["loss_sum"], ref["global"]["loss_sum"],
                 rtol=1e-4, atol=1e-4)
    for k in ("score_sum", "n"):
        assert_close(f"{case}: {k}", port["global"][k], ref["global"][k], rtol=0, atol=0)
    assert port["global"]["n"] == 40.0


# --- the entry point ----------------------------------------------------------

ENTRY_CONTROL = "1_5_0.4_non-iid-2_fix_a1-e1_bn_1_1"
SIZES = '{"train": 200, "test": 40}'
TINY = '"conv": {"hidden_size": [8, 16]}'


def _argv(out_dir, rounds, extra=()):
    return ["--device", "cpu", "--output_dir", str(out_dir),
            "--control_name", ENTRY_CONTROL, "--data_name", "MNIST",
            "--model_name", "conv", "--synthetic", "1", "--pallas_norm", "1",
            "--synthetic_sizes", SIZES,
            "--override", f'{{"num_epochs": {{"global": {rounds}, "local": 1}}, {TINY}}}',
            *extra]


def test_entry_int8_with_evaluation_on_cpu(tmp_path):
    """``--wire_codec int8 --eval_interval 1``: two finite rounds, each
    followed by sBN and finite Local and Global metrics; the residual carry
    is non-zero after the first round and after the run."""
    (res,) = train_classifier_fed.main(_argv(tmp_path, 2, ["--wire_codec", "int8", "--eval_interval", "1"]))
    hist = res["history"]
    assert [r["epoch"] for r in hist] == [1, 2]
    for r in hist:
        for k in ("loss", "Local-Loss", "Local-Accuracy", "Global-Loss", "Global-Accuracy"):
            assert math.isfinite(r[k]), (k, r)
    assert res["bn_state"] and res["wire_resid"].shape[0] == 1
    assert np.any(res["wire_resid"] != 0)
    cfg = PC.default_cfg()
    cfg.update(control=PC.parse_control_name(ENTRY_CONTROL), data_name="MNIST",
               model_name="conv", device="cpu", synthetic=True, wire_codec="int8",
               output_dir=str(tmp_path),
               synthetic_sizes={"train": 200, "test": 40},
               override={"num_epochs": {"local": 1}, "conv": {"hidden_size": [8, 16]}})
    exp = FedExperiment(PC.process_control(cfg), seed=0)
    exp.stage(*exp.make_splits())
    exp.train_round(exp.engine.flatten(exp.model.params()), 1, 0.01)
    assert np.any(exp.engine.wire_resid_host() != 0)


def test_entry_eval_cadence(tmp_path):
    """Evaluation runs when ``epoch % eval_interval == 0`` and after the last
    round; the dense run carries no residual."""
    (res,) = train_classifier_fed.main(_argv(tmp_path, 3, ["--eval_interval", "2"]))
    evaluated = [r["epoch"] for r in res["history"] if "Global-Accuracy" in r]
    assert evaluated == [2, 3]
    assert res["wire_resid"] is None
