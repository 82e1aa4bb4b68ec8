"""The masked-LM entry points of the PyTorch/CUDA port on the CPU:
``train_transformer_fed`` with its checkpoint (the reference's layout,
read by the reference), resume equal bit for bit to an uninterrupted run,
``test_transformer_fed`` reproducing the logged Global-Perplexity, a
checkpoint the reference writes read by the port, and the centralised
``train_transformer`` / ``test_transformer``.  Synthetic WikiText2 (512
tokens), E 32, 2 heads, FFN 64, 2 layers, bptt 16."""

import json
import math
import shutil

import jax
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.data import fetch_dataset as r_fetch
from heterofl_tpu.data import process_dataset as r_process_dataset
from heterofl_tpu.data import split_dataset as r_split
from heterofl_tpu.entry import test_transformer_fed as r_test_fed
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.utils import checkpoint as rckpt
from heterofl_tpu_torch.convert import params_to_jax
from heterofl_tpu_torch.entry import (test_transformer, test_transformer_fed, train_transformer,
                                      train_transformer_fed)
from heterofl_tpu_torch.entry.common import FedExperiment
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint as ckpt

few_threads = thread_limit_fixture()

CONTROL = "1_4_0.5_iid_fix_a1-e1_bn_1_1"
TAG = f"0_WikiText2_label_transformer_{CONTROL}"
CENTRAL = "1_1_1_none_fix_a1_bn_1_1"
CENTRAL_TAG = f"0_WikiText2_label_transformer_{CENTRAL}"
SIZES = {"train": 3200, "test": 800}  # 100 rows of 32 tokens; 10 rows of 80
SMALL = {"transformer": {"embedding_size": 32, "num_heads": 2, "hidden_size": 64,
                         "num_layers": 2, "dropout": 0.2}, "bptt": 16}


def _argv(out, rounds, *extra, port=True, control=CONTROL):
    epochs = rounds if control == CENTRAL else {"global": rounds, "local": 1}
    argv = ["--output_dir", str(out), "--control_name", control, "--synthetic", "1",
            "--synthetic_sizes", json.dumps(SIZES),
            "--override", json.dumps({**SMALL, "num_epochs": epochs}), *extra]
    return argv + (["--device", "cpu"] if port else ["--sampler", "perm"])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Three rounds of the port's ``train_transformer_fed``, evaluated
    every round -> (output dir, result)."""
    out = tmp_path_factory.mktemp("lm_run")
    (res,) = train_transformer_fed.main(_argv(out, 3))
    return out, res


def _ref_cfg():
    cfg = RC.default_cfg()
    cfg.update(control=RC.parse_control_name(CONTROL), data_name="WikiText2",
               model_name="transformer", synthetic=True, synthetic_sizes=SIZES, override=SMALL)
    return RC.process_control(cfg)


def test_lm_checkpoint_is_in_the_reference_layout(port_run):
    """The blob holds the reference's keys and its params at the reference
    model's shapes (the embedding tables untransposed); the pivot is the
    least Global-Perplexity; the ``<mask>`` row of the token embedding
    never moves from its initial value."""
    out, res = port_run
    blob = ckpt.load_checkpoint(ckpt.checkpoint_path(str(out), TAG))
    rcfg, _ = r_process_dataset(_ref_cfg(), r_fetch("WikiText2", synthetic=True,
                                                    synthetic_sizes=SIZES))
    rshapes = {k: v.shape for k, v in
               jax.eval_shape(r_make_model(rcfg).init, jax.random.key(0)).items()}
    assert {k: v.shape for k, v in blob["params"].items()} == rshapes
    assert blob["params"]["embedding.tok.w"].shape == (513, 32)
    np.testing.assert_array_equal(blob["params"]["embedding.tok.w"],
                                  res["params"]["embedding.tok.w"].numpy())
    ppl = res["logger"].history["test/Global-Perplexity"]
    assert len(ppl) == 3 and blob["pivot"] == min(ppl) and blob["epoch"] == 4
    assert blob["bn_state"] == {} and blob["wire_resid"] is None
    assert all(math.isfinite(r["loss"]) and r["perplexity"] > 1 for r in res["history"])
    init = make_model(dict(rcfg, device="cpu")).init_(torch.Generator().manual_seed(0))
    torch.testing.assert_close(res["params"]["embedding.tok.w"][-1],
                               init.params()["embedding.tok.w"][-1].detach(), rtol=0, atol=0)


def test_test_entry_reproduces_logged_global_perplexity(port_run):
    """``test_transformer_fed`` on the best checkpoint evaluates it at the
    epoch it was logged at (the corruption draws seeded from it): the
    Global loss and perplexity equal the logged ones on the same device."""
    out, _ = port_run
    hist = ckpt.load_checkpoint(ckpt.checkpoint_path(str(out), TAG, "best"))["logger_history"]
    (bundle,) = test_transformer_fed.main(_argv(out, 3))
    got = bundle["logger_history"]
    for k in ("Global-Loss", "Global-Perplexity"):
        assert_close(f"test_transformer_fed reproduces the logged {k}", got[f"test/{k}"][0],
                     hist[f"test/{k}"][-1], rtol=0, atol=0)


def test_reference_reads_port_lm_checkpoint(port_run, tmp_path):
    """The reference's ``test_transformer_fed`` evaluates the port's best
    checkpoint (its own draws, so the value is its own): a finite Global
    perplexity near the logged one."""
    out = shutil.copytree(port_run[0], tmp_path / "run")
    hist = ckpt.load_checkpoint(ckpt.checkpoint_path(str(out), TAG, "best"))["logger_history"]
    (bundle,) = r_test_fed.main(_argv(out, 3, port=False))
    ppl = bundle["logger_history"]["test/Global-Perplexity"][0]
    assert math.isfinite(ppl) and abs(ppl / hist["test/Global-Perplexity"][-1] - 1) < 0.2


def test_port_reads_reference_lm_checkpoint(tmp_path, monkeypatch):
    """A blob the reference's checkpoint writer stores (its model's init
    params, its data split): the port resumes from it (``resume_mode 2``)
    starting from exactly its params, and evaluates it."""
    rcfg, rset = r_process_dataset(_ref_cfg(), r_fetch("WikiText2", synthetic=True,
                                                       synthetic_sizes=SIZES))
    rparams = {k: np.asarray(v)
               for k, v in jax.jit(r_make_model(rcfg).init)(jax.random.key(1)).items()}
    split, lsplit = r_split(rset, 4, "iid", np.random.default_rng(0))
    rckpt.save_checkpoint(rckpt.checkpoint_path(str(tmp_path), TAG), {
        "cfg": {k: v for k, v in rcfg.items() if k != "vocab"}, "epoch": 2,
        "data_split": split, "label_split": lsplit, "params": rparams, "bn_state": {},
        "pivot": float("inf"), "logger_history": {}})
    start = {}
    train_round = FedExperiment.train_round

    def first(self, P, epoch, lr):
        start.setdefault("params", params_to_jax(self.engine.unflatten(P), self.perms))
        return train_round(self, P, epoch, lr)

    monkeypatch.setattr(FedExperiment, "train_round", first)
    (res,) = train_transformer_fed.main(_argv(tmp_path, 1, "--resume_mode", "2"))
    for k, v in rparams.items():
        np.testing.assert_array_equal(start["params"][k], v, err_msg=k)
    assert res["data_split"] == split
    rckpt.save_checkpoint(rckpt.checkpoint_path(str(tmp_path), TAG, "best"), {
        "cfg": {}, "epoch": 2, "data_split": split, "label_split": lsplit, "params": rparams})
    (bundle,) = test_transformer_fed.main(_argv(tmp_path, 1))
    assert math.isfinite(bundle["logger_history"]["test/Global-Perplexity"][0])


COHORTS = {1: [0, 3], 2: [2, 1], 3: [3, 1]}


def test_lm_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """Two rounds, a checkpoint, then a resumed third round equal bit for
    bit to three rounds in one run (the cohort pinned per round): params
    and the logger history."""
    monkeypatch.setattr(FedExperiment, "sample_users",
                        lambda self, epoch: np.array(COHORTS[epoch], np.int64))
    (full,) = train_transformer_fed.main(_argv(tmp_path / "full", 3))
    train_transformer_fed.main(_argv(tmp_path / "cut", 2))
    (res,) = train_transformer_fed.main(_argv(tmp_path / "cut", 3, "--resume_mode", "1"))
    assert [r["epoch"] for r in res["history"]] == [3]
    for k, v in full["params"].items():
        assert torch.equal(res["params"][k], v), k
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    assert hist(res) == hist(full) and len(hist(res)["test/Global-Perplexity"]) == 3


def test_central_lm_entries(tmp_path):
    """``train_transformer`` for two epochs (100 rows of bptt 16 a step)
    and ``test_transformer`` on its best checkpoint, which reproduces the
    logged test loss and perplexity on the same device."""
    argv = _argv(tmp_path, 2, control=CENTRAL)
    (res,) = train_transformer.main(argv)
    hist = res["history"]
    assert [r["epoch"] for r in hist] == [1, 2]
    assert all(math.isfinite(r[k]) for r in hist for k in ("loss", "perplexity", "Perplexity"))
    best = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), CENTRAL_TAG, "best"))
    (bundle,) = test_transformer.main(argv)
    for k in ("Loss", "Perplexity"):
        assert_close(f"test_transformer reproduces the logged {k}", bundle["metrics"][k],
                     best["logger_history"][f"test/{k}"][-1], rtol=0, atol=0)


def test_lm_entry_raises_without_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        train_transformer_fed.main(_argv(tmp_path, 1)[:-2])
