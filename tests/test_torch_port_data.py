"""Config and data parity of the PyTorch/CUDA port against the JAX
reference: the same control strings give the same derived config, the same
seeds give identical synthetic arrays, splits, stacks and label masks."""

import numpy as np
import pytest

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import label_split_masks as r_lsm
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.data import stack_client_shards as r_stack
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.data import fetch_dataset, label_split_masks, split_dataset, stack_client_shards
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

# keys the port reads from a processed cfg
PORT_KEYS = ("control_name", "model_split_rate", "fed", "num_users", "frac", "data_split_mode",
             "model_split_mode", "model_mode", "norm", "scale", "mask", "global_model_mode",
             "global_model_rate", "model_rate", "conv", "resnet", "data_shape",
             "optimizer_name", "lr", "momentum", "weight_decay", "scheduler_name", "factor",
             "num_epochs", "batch_size", "milestones", "data_name", "model_name")


def _both(control, data_name, model_name):
    out = []
    for mod in (RC, PC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name(control)
        cfg["data_name"], cfg["model_name"] = data_name, model_name
        out.append(mod.process_control(cfg))
    return out


@pytest.mark.parametrize("control,data_name,model_name", [
    ("1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1", "MNIST", "conv"),
    ("1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1", "CIFAR10", "resnet18"),
    ("1_100_0.1_non-iid-2_fix_a2-b8_bn_1_1", "CIFAR10", "resnet18"),
    ("1_10_0.5_iid_fix_a1-e1_none_0_0", "FashionMNIST", "conv"),
])
def test_process_control_matches_reference(control, data_name, model_name):
    ref, port = _both(control, data_name, model_name)
    for k in PORT_KEYS:
        assert port[k] == ref[k], k


def test_unported_keys_raise_naming_the_key():
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name("1_100_0.1_iid_fix_a1_bn_1_1")
    for key, value in (("data_placement", "sharded"), ("arms", {"lr": [0.1, 0.2]}),
                       ("level_placement", "slices"), ("world_size", 2)):
        bad = dict(cfg, **{key: value})
        with pytest.raises(NotImplementedError, match=key):
            PC.process_control(bad)
    # observability and its guards are ported
    done = PC.process_control(dict(cfg, telemetry="hist", quarantine="on", ledger="on",
                                   watchdog={"action": "rollback"}, chaos_poison=[[1, 2]]))
    assert (done["telemetry"], done["quarantine"], done["ledger"]) == ("hist", "on", "on")
    # the streaming store and the schedule commitment are ported
    done = PC.process_control(dict(cfg, client_store="stream", sample_horizon=1))
    assert (done["client_store"], done["sample_horizon"]) == ("stream", 1)
    # the superstep and the prp sampler are ported
    done = PC.process_control(dict(cfg, superstep_rounds=4, metrics_fetch_every=4,
                                   sampler="prp"))
    assert (done["superstep_rounds"], done["sampler"]) == (4, "prp")
    # the grouped and sliced strategies are ported; a per-level codec map
    # outside grouped, and an unknown strategy, are refused as in the reference
    for strategy in ("grouped", "sliced"):
        assert PC.process_control(dict(cfg, strategy=strategy))["strategy"] == strategy
    with pytest.raises(ValueError, match="wire_codec"):
        PC.process_control(dict(cfg, wire_codec={"1.0": "int8"}))
    with pytest.raises(ValueError, match="strategy"):
        PC.process_control(dict(cfg, strategy="vmapped"))
    # the dynamic rate mode is ported: the mode rates and their weights
    dyn = dict(cfg, control=PC.parse_control_name("1_100_0.1_iid_dynamic_a1-e3_bn_1_1"))
    dyn = PC.process_control(dyn)
    assert dyn["model_rate"] == [1.0, 0.0625] and dyn["proportion"] == [0.25, 0.75]
    # the folder datasets are not
    for data_name in ("ImageNet", "Omniglot", "ImageFolder"):
        with pytest.raises(NotImplementedError, match="data_name"):
            PC.process_control(dict(cfg, data_name=data_name))


@pytest.mark.parametrize("data_name,split_mode", [("CIFAR10", "iid"), ("MNIST", "iid"),
                                                  ("MNIST", "non-iid-2")])
def test_data_pipeline_identical(data_name, split_mode):
    sizes = {"train": 600, "test": 120}
    ref = r_fetch(data_name, synthetic=True, seed=3, synthetic_sizes=sizes)
    port = fetch_dataset(data_name, synthetic=True, seed=3, synthetic_sizes=sizes)
    for split in ("train", "test"):
        np.testing.assert_array_equal(port[split].data, ref[split].data)
        np.testing.assert_array_equal(port[split].target, ref[split].target)
        assert port[split].classes_size == ref[split].classes_size
        assert port[split].augment == ref[split].augment
    users = 10
    r_ds, r_ls = r_split(ref, users, split_mode, np.random.default_rng(5), classes_size=10)
    p_ds, p_ls = split_dataset(port, users, split_mode, np.random.default_rng(5), classes_size=10)
    assert p_ds == r_ds and dict(p_ls) == dict(r_ls)
    # unequal shards exercise the repeat-padding with sample_mask 0
    r_ds["train"][1] = r_ds["train"][1][:-7]
    p_ds["train"][1] = p_ds["train"][1][:-7]
    uids = [0, 1, 4, 9]
    for a, b in zip(stack_client_shards(port["train"].data, port["train"].target,
                                        p_ds["train"], uids),
                    r_stack(ref["train"].data, ref["train"].target, r_ds["train"], uids)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(label_split_masks(p_ls, users, 10), r_lsm(r_ls, users, 10))


def test_on_disk_data_is_not_silently_synthetic(tmp_path):
    """Without ``synthetic`` absent files raise, naming what was looked for
    and the flag that asks for the synthetic twin (the reference falls back
    to synthetic data there)."""
    for data_name, looked_for in (("CIFAR10", "cifar-10-python.tar.gz"),
                                  ("CIFAR100", "cifar-100-binary"),
                                  ("MNIST", "train,t10k"), ("FashionMNIST", "images-idx3"),
                                  ("EMNIST", "emnist-balanced"),
                                  ("WikiText2", "wiki.train.tokens")):
        with pytest.raises(FileNotFoundError, match="synthetic=1") as err:
            fetch_dataset(data_name, data_dir=str(tmp_path), synthetic=False)
        assert looked_for in str(err.value) and str(tmp_path) in str(err.value)
