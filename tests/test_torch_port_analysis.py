"""The analysis tools and the per-level tables of the PyTorch/CUDA port,
against the JAX package on the CPU.

Contracts:

* ``analysis.summary.module_table`` rows equal the reference's exactly (as
  integers): conv, ResNet-18, ResNet-50 and the transformer, levels a and
  e, at small widths and at the headline's full widths;
* every ``fed.core.level_*`` table equals the reference's: parameters,
  bytes and codec bytes exactly (dense, int8, signsgd, topk, a per-level
  codec map), FLOPs and their shares to relative 1e-12;
* ``flop_count`` of one training-mode forward equals the stated contract
  ``summary.matmul_flops`` (2 x the matmul-like rows' MACs, without the
  conv net's bias terms, the embedding lookup and the average pool)
  exactly, at every level;
* ``profile_model``'s ``num_params`` and ``space_mb`` equal the
  reference's, and ``make_summary`` writes the reference's bundle keys;
* ``parse_tag``, ``aggregate`` and the csv over result bundles written by
  both packages' ``test_classifier_fed`` equal the reference's;
* ``build_controls`` equals the reference's list for list, and
  ``make_script`` runs the port's entries round-robin over ``--gpus``.
"""

import json
import pickle

import numpy as np
import pytest

from heterofl_tpu import config as RC
from heterofl_tpu.analysis import make as r_make
from heterofl_tpu.analysis import process as r_process
from heterofl_tpu.analysis import summary as r_summary
from heterofl_tpu.entry import test_classifier_fed as r_test_fed
from heterofl_tpu.fed import core as r_core
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.analysis import make, process, summary
from heterofl_tpu_torch.entry import test_classifier_fed, train_classifier_fed
from heterofl_tpu_torch.fed import core
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

CONTROL = "1_10_0.5_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
SMALL = {"conv": {"hidden_size": [8, 16]}, "resnet": {"hidden_size": [8, 16, 16, 16]},
         "transformer": {"embedding_size": 32, "num_heads": 2, "hidden_size": 64,
                         "num_layers": 2, "dropout": 0.2}}
DATA = {"conv": "MNIST", "resnet18": "CIFAR10", "resnet50": "CIFAR10",
        "transformer": "WikiText2"}


def _cfg(mod, model, small):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg.update(data_name=DATA[model], model_name=model)
    cfg = mod.process_control(cfg)
    if small:
        cfg.update(SMALL)
    if model == "transformer":
        cfg["num_tokens"] = cfg["classes_size"] = 50 if small else 33278
    else:
        cfg["classes_size"] = 10
    return cfg


@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
@pytest.mark.parametrize("model", ["conv", "resnet18", "resnet50", "transformer"])
def test_module_table_equals_reference(model, small):
    pcfg, rcfg = _cfg(PC, model, small), _cfg(RC, model, small)
    for rate in (1.0, 0.0625):
        assert summary.module_table(pcfg, rate) == r_summary.module_table(rcfg, rate), rate


def _assert_tables(pcfg, rcfg):
    assert core.level_param_table(pcfg) == r_core.level_param_table(rcfg)
    assert core.level_byte_table(pcfg) == r_core.level_byte_table(rcfg)
    for codec in ("dense", "int8", "signsgd", "topk"):
        assert core.level_codec_byte_table(pcfg, codec, n_leaves=7) == \
            r_core.level_codec_byte_table(rcfg, codec, n_leaves=7), codec
    cmap = {1.0: "dense", 0.5: "int8", 0.25: "topk", 0.125: "signsgd", 0.0625: "int8"}
    assert core.level_codec_map_byte_table(pcfg, cmap, n_leaves=3) == \
        r_core.level_codec_map_byte_table(rcfg, cmap, n_leaves=3)
    with pytest.raises(ValueError, match="misses levels"):
        core.level_codec_map_byte_table(pcfg, {1.0: "dense"})
    for port, ref in ((core.level_flop_table(pcfg), r_core.level_flop_table(rcfg)),
                      (core.level_flop_shares(pcfg), r_core.level_flop_shares(rcfg)),
                      (core.level_flop_shares(pcfg, {1.0: 2.0, 0.25: 1.0}),
                       r_core.level_flop_shares(rcfg, {1.0: 2.0, 0.25: 1.0}))):
        assert sorted(port) == sorted(ref)
        for r in ref:
            assert port[r] == pytest.approx(ref[r], rel=1e-12, abs=0.0), r
    assert core.level_flop_table(pcfg, [0.5]) == pytest.approx(r_core.level_flop_table(
        rcfg, [0.5]), rel=1e-12)


@pytest.mark.parametrize("model,small", [("conv", True), ("resnet18", True),
                                         ("resnet18", False), ("transformer", True)])
def test_level_tables_equal_reference(model, small):
    _assert_tables(_cfg(PC, model, small), _cfg(RC, model, small))


def test_level_tables_follow_the_global_rate():
    """A global mode below a: the width rate is the level over the global
    rate, as in the reference."""
    pcfg, rcfg = _cfg(PC, "conv", True), _cfg(RC, "conv", True)
    for cfg, mod in ((pcfg, PC), (rcfg, RC)):
        cfg["control"] = mod.parse_control_name("1_10_0.5_iid_fix_b1-c1-e1_bn_1_1")
    pcfg = dict(PC.process_control(pcfg), **SMALL, classes_size=10)
    rcfg = dict(RC.process_control(rcfg), **SMALL, classes_size=10)
    assert core.level_byte_table(pcfg) == r_core.level_byte_table(rcfg)
    assert core.level_flop_table(pcfg) == pytest.approx(r_core.level_flop_table(rcfg),
                                                        rel=1e-12)


@pytest.mark.parametrize("model", ["conv", "resnet18", "transformer"])
def test_flop_count_equals_the_matmul_contract(model):
    cfg = _cfg(PC, model, True)
    for rate in sorted(set(cfg["model_rate"]), reverse=True):
        m = make_model(cfg, rate)
        batch = summary.example_batch(cfg, m, cfg["batch_size"]["train"], "cpu")
        got = summary.flop_count(lambda: summary.model_forward(m, batch))
        want = summary.matmul_flops(cfg, summary.module_table(cfg, rate))
        print(f"parity flop_count {model} rate {rate:g}: {got} == {want}")
        assert got == want, rate


def test_profile_model_and_summary_bundle(tmp_path):
    pcfg, rcfg = _cfg(PC, "conv", True), _cfg(RC, "conv", True)
    for rate in (1.0, 0.0625):
        port, ref = summary.profile_model(pcfg, rate), r_summary.profile_model(rcfg, rate)
        assert port["num_params"] == ref["num_params"]
        assert port["space_mb"] == ref["space_mb"]
        # the same leaves and sizes (the port's layout is PyTorch's: OIHW, [out, in])
        assert sorted((k, n) for k, _s, n in port["per_param"]) == \
            sorted((k, n) for k, _s, n in ref["per_param"])
        assert port["flops_source"] == "torch_flop_counter"
        assert port["num_flops"] == summary.matmul_flops(pcfg, summary.module_table(pcfg, rate))
    pcfg["output_dir"] = str(tmp_path)
    out = summary.make_summary(pcfg, rates=[1.0, 0.5])
    with open(tmp_path / "result" / "MNIST_conv_a.pkl", "rb") as f:
        bundle = pickle.load(f)
    assert sorted(bundle) == ["flops_source", "num_flops", "num_params", "space_mb"]
    assert bundle["num_params"] == out["results"]["a"]["num_params"]
    assert (tmp_path / "summary.md").exists() and "| b | 0.5 |" in out["report"]
    # the interpolation ratio reads these bundles
    a, b = out["results"]["a"]["num_params"], out["results"]["b"]["num_params"]
    assert process.mode_ratio(str(tmp_path), "MNIST", "conv", "a5-b5") == \
        pytest.approx(0.5 + 0.5 * b / a)
    assert process.mode_ratio(str(tmp_path), "MNIST", "conv", "a5-c5") == \
        pytest.approx(0.5 + 0.5 * 0.25 ** 2)  # no level-c bundle: rates squared for all


FED_CONTROL = "1_4_0.5_iid_fix_a1-e1_bn_1_1"


def _argv(out, seed, port=True):
    argv = ["--output_dir", str(out), "--control_name", FED_CONTROL, "--data_name", "MNIST",
            "--model_name", "conv", "--synthetic", "1", "--synthetic_sizes",
            '{"train": 80, "test": 20}', "--init_seed", str(seed), "--num_experiments", "1",
            "--override", json.dumps({"num_epochs": {"global": 1, "local": 1},
                                      "conv": {"hidden_size": [4, 8]}})]
    return argv + (["--device", "cpu"] if port else ["--sampler", "perm"])


def test_process_aggregates_both_packages_bundles(tmp_path):
    """Seeds 0 and 1 trained by the port; seed 0's bundle written by the
    port's test entry, seed 1's by the reference's on the port's
    checkpoint: both packages' ``load_results``, ``aggregate`` and csv give
    the same rows, aggregates and file."""
    for seed in (0, 1):
        train_classifier_fed.main(_argv(tmp_path, seed))
    test_classifier_fed.main(_argv(tmp_path, 0))
    r_test_fed.main(_argv(tmp_path, 1, port=False))
    (tmp_path / "result" / "not_a_tag.pkl").write_bytes(pickle.dumps({}))
    rows, r_rows = process.load_results(str(tmp_path)), r_process.load_results(str(tmp_path))
    assert [r["tag"] for r in rows] == [r["tag"] for r in r_rows] and len(rows) == 2
    for r, rr in zip(rows, r_rows):
        assert {k: v for k, v in r.items() if k != "train_history"} == \
            {k: v for k, v in rr.items() if k != "train_history"}
    agg, r_agg = process.aggregate(rows), r_process.aggregate(r_rows)
    assert sorted(agg) == sorted(r_agg) and len(agg) == 1
    for key in agg:
        assert agg[key]["n_seeds"] == r_agg[key]["n_seeds"] == 2
        assert agg[key]["mean"] == r_agg[key]["mean"] and agg[key]["std"] == r_agg[key]["std"]
        logged = [r["metrics"]["Global-Accuracy"] for r in rows]
        assert agg[key]["mean"]["Global-Accuracy"] == float(np.mean(logged))
    csv = process.export_table(agg, str(tmp_path / "port"))
    r_csv = r_process.export_table(r_agg, str(tmp_path / "ref"))
    assert open(csv).read() == open(r_csv).read()


@pytest.mark.parametrize("tag", [
    "0_MNIST_label_conv_1_100_0.1_iid_fix_a1-b1_bn_1_1",
    "3_CIFAR10_resnet18_1_100_0.1_non-iid-2_dynamic_a1-e1_gn_0_1",
    "1_WikiText2_transformer_1_100_0.01_iid_fix_a1_bn_1_1",
    "0_Stacked_MNIST_x_conv_1_100_0.1_iid_fix_a1_bn_1_1",
    "0_MNIST_label_vgg_1_100_0.1_iid_fix_a1_bn_1_1",
    "x_MNIST_conv_1_100_0.1_iid_fix_a1_bn_1_1",
    "0_MNIST_conv_1_100_0.1_iid_fix_a1_bn_2_1",
    "0_MNIST_conv_1_100",
])
def test_parse_tag_equals_reference(tag):
    assert process.parse_tag(tag) == r_process.parse_tag(tag)


@pytest.mark.parametrize("model", ["conv", "resnet18", "transformer"])
def test_build_controls_equal_reference(model):
    for fed in (0, 1):
        for split in ("iid", "non-iid-2"):
            for ablation in (False, True):
                assert make.build_controls(model, fed, split, ablation) == \
                    r_make.build_controls(model, fed, split, ablation)
    assert make.interp_modes() == r_make.interp_modes()
    assert make.combination_modes() == r_make.combination_modes()


def test_make_script_targets_the_port_round_robin():
    s = make.make_script("train", "conv", 1, "iid", gpus=["0", "1", "2"], round_size=3,
                         modes=["a1", "b1", "c1", "d1"], synthetic=True)
    jobs = [ln for ln in s.splitlines() if "python -m" in ln]
    assert len(jobs) == 4 and s.startswith("#!/bin/bash\n") and s.endswith("wait\n")
    assert all("python -m heterofl_tpu_torch.entry.train_classifier_fed " in j for j in jobs)
    assert [j.split()[0] for j in jobs] == ["CUDA_VISIBLE_DEVICES=0", "CUDA_VISIBLE_DEVICES=1",
                                           "CUDA_VISIBLE_DEVICES=2", "CUDA_VISIBLE_DEVICES=0"]
    lines = s.splitlines()
    assert lines[4] == "wait" and not lines[3].endswith("&") and lines[1].endswith("&")
    ref = r_make.make_script("train", "conv", 1, "iid", round_size=3,
                             modes=["a1", "b1", "c1", "d1"], synthetic=True)
    strip = lambda t: [ln.split(" ", 1)[1] if ln.startswith("CUDA") else ln  # noqa: E731
                       for ln in t.splitlines()]
    assert [ln.replace("heterofl_tpu_torch.", "heterofl_tpu.") for ln in strip(s)] == \
        strip(ref)
    one = make.make_script("test", "transformer", 0, "iid")
    assert "CUDA_VISIBLE_DEVICES=0 python -m heterofl_tpu_torch.entry.test_transformer " in one
