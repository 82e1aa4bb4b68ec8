"""The centralised baseline of the PyTorch/CUDA port against the JAX
reference on the CPU: the ``data_split_mode='none'`` configuration, the
epoch's shuffled batches, two epochs of ``CentralEngine.train_epoch`` from
the same params on the same batches, the entries end to end, and resume
with the optimizer state equal bit for bit to an uninterrupted run.  MNIST
conv twin at hidden 8/16 (no augmentation), synthetic data."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.entry.central import CentralEngine as RCentralEngine
from heterofl_tpu.entry.central import CentralExperiment as RCentralExperiment
from heterofl_tpu.models import make_model as r_make_model
from heterofl_tpu.parallel import make_mesh
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
from heterofl_tpu_torch.entry import test_classifier, train_classifier
from heterofl_tpu_torch.entry.central import CentralEngine, CentralExperiment
from heterofl_tpu_torch.models import make_model
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint as ckpt

few_threads = thread_limit_fixture()

CONTROL = "1_1_1_none_fix_a1_bn_1_1"
TAG = f"0_MNIST_label_conv_{CONTROL}"
HIDDEN = {"conv": {"hidden_size": [8, 16]}}
BATCH = 16  # divides among the reference mesh's 8 CPU devices
N_TRAIN = 72  # 5 batches, the last half padding


@pytest.mark.parametrize("data_name", ["MNIST", "CIFAR10"])
def test_process_control_none_matches_reference(data_name):
    """``none``: epochs (an int), batch 100 / 500, the reference's
    milestones, lr and optimizer."""
    out = []
    for mod in (PC, RC):
        cfg = mod.default_cfg()
        cfg["control"] = mod.parse_control_name(CONTROL)
        cfg["data_name"] = data_name
        out.append(mod.process_control(cfg))
    keys = ("num_epochs", "batch_size", "milestones", "lr", "optimizer_name", "momentum",
            "weight_decay", "scheduler_name", "factor", "model_rate", "global_model_rate")
    assert {k: out[0][k] for k in keys} == {k: out[1][k] for k in keys}
    assert out[0]["batch_size"] == {"train": 100, "test": 500}


def _cfg(mod, **extra):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(CONTROL)
    cfg.update(data_name="MNIST", model_name="conv", synthetic=True,
               synthetic_sizes={"train": N_TRAIN, "test": 40}, **extra)
    cfg["override"] = {**HIDDEN, "num_epochs": 2, "batch_size": {"train": BATCH, "test": 20}}
    return mod.process_control(cfg)


def test_epoch_batches_match_reference():
    """The same seed shuffles the train set into the same padded batches
    (``self.rng.permutation`` each epoch, zero images of weight 0 at the
    tail) on both sides, two epochs running."""
    exp = CentralExperiment(_cfg(PC, device="cpu"), 0)
    rexp = RCentralExperiment(_cfg(RC), 0)
    for _ in range(2):
        got, want = exp.epoch_batches(1), rexp._epoch_batches()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)
    assert got[2].sum() == N_TRAIN and got[0].shape == (5, BATCH, 28, 28, 1)


def test_central_epochs_match_reference():
    """Two epochs of ``train_epoch`` from the same params on the same
    shuffled batches against the reference's ``CentralEngine`` on one
    device of its mesh (batch statistics over the whole batch, as on one
    GPU): params after each epoch to atol 5e-5 (the one-round test's contract;
    float32 convolutions and reductions in another order, momentum
    carried), the momentum buffers to the same atol, loss sums to rtol/atol
    1e-4, the correct counts and ``n`` exactly."""
    rcfg, pcfg = _cfg(RC), _cfg(PC, device="cpu")
    rcfg["classes_size"] = pcfg["classes_size"] = 10
    rmodel = r_make_model(rcfg)
    params = {k: np.asarray(v) for k, v in rmodel.init(jax.random.key(0)).items()}
    reng = RCentralEngine(rmodel, rcfg, make_mesh(1, 1))
    model = make_model(pcfg)
    eng = CentralEngine(model, pcfg, torch.device("cpu"))
    p = params_from_jax(params)
    opt = eng.init_opt(p)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    ropt = reng.init_opt(rp)
    rexp = RCentralExperiment(rcfg, 3)
    for epoch in (1, 2):
        x, y, w = rexp._epoch_batches()
        lr = 0.05 / epoch
        rp, ropt, (lsum, csum, n) = reng.train_epoch(rp, ropt, jax.random.key(epoch), lr, x, y, w)
        p, opt, acc = eng.train_epoch(p, opt, lr, *(torch.from_numpy(a) for a in (x, y, w)))
        case = f"central epoch {epoch}"
        r_np = {k: np.asarray(v) for k, v in rp.items()}
        names = sorted(r_np)
        flat = lambda d: np.concatenate([d[k].ravel() for k in names])  # noqa: E731
        assert_close(f"{case}: params", flat(params_to_jax(p)), flat(r_np), rtol=0, atol=5e-5)
        assert_close(f"{case}: momentum", flat(params_to_jax(opt["slots"])),
                     flat({k: np.asarray(v) for k, v in ropt.slots.items()}), rtol=0, atol=5e-5)
        assert_close(f"{case}: loss_sum", acc[0], float(lsum), rtol=1e-4, atol=1e-4)
        assert_close(f"{case}: correct, n", acc[1:], np.array([float(csum), float(n)]),
                     rtol=0, atol=0)
        assert opt["step"] == int(ropt.step) == 5 * epoch


def _argv(out, epochs, *extra):
    return ["--device", "cpu", "--output_dir", str(out), "--control_name", CONTROL,
            "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
            "--synthetic_sizes", json.dumps({"train": N_TRAIN, "test": 40}),
            "--override", json.dumps({**HIDDEN, "num_epochs": epochs,
                                      "batch_size": {"train": BATCH, "test": 20}}), *extra]


def test_entries_end_to_end(tmp_path):
    """``train_classifier`` then ``test_classifier``: a test entry per epoch,
    a checkpoint with the optimizer state in the reference's layout, and a
    result bundle whose Accuracy is the one logged for the best epoch."""
    (res,) = train_classifier.main(_argv(tmp_path, 2))
    hist = res["logger"].history
    assert len(hist["test/Accuracy"]) == 2 and len(hist["train/Loss"]) == 2
    blob = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), TAG))
    assert blob["epoch"] == 3 and blob["opt_state"]["step"] == 10
    assert blob["opt_state"]["slots"]["block0.conv.w"].shape == (3, 3, 1, 8)  # HWIO
    (out,) = test_classifier.main(_argv(tmp_path, 2))
    assert "Accuracy" in out["metrics"]
    best = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path), TAG, "best"))
    assert_close("central test entry vs logged: Accuracy", out["metrics"]["Accuracy"],
                 best["logger_history"]["test/Accuracy"][-1], rtol=1e-4, atol=1e-4)
    assert_close("central test entry vs logged: Loss", out["metrics"]["Loss"],
                 best["logger_history"]["test/Loss"][-1], rtol=1e-4, atol=1e-4)


def test_resume_equals_uninterrupted_with_opt_state(tmp_path, monkeypatch):
    """Two epochs, a checkpoint, then a resumed third epoch equal bit for
    bit to three epochs in one run, momentum included (the shuffle pinned
    per epoch: a resumed run restarts the numpy stream)."""
    monkeypatch.setattr(CentralExperiment, "epoch_permutation",
                        lambda self, epoch: np.random.default_rng(100 + epoch).permutation(N_TRAIN))
    (full,) = train_classifier.main(_argv(tmp_path / "full", 3))
    train_classifier.main(_argv(tmp_path / "cut", 2))
    (res,) = train_classifier.main(_argv(tmp_path / "cut", 3, "--resume_mode", "1"))
    assert [r["epoch"] for r in res["history"]] == [3]
    for k, v in full["params"].items():
        assert torch.equal(res["params"][k], v), k
    assert res["opt_state"]["step"] == full["opt_state"]["step"] == 15
    for k, v in full["opt_state"]["slots"].items():
        assert torch.equal(res["opt_state"]["slots"][k], v), k


def test_reference_central_blob_is_refused(tmp_path):
    """A centralised blob of the JAX package pickles its ``OptState`` class:
    the port says so instead of resuming from it."""
    exp = CentralExperiment(_cfg(PC, device="cpu"), 0)
    with pytest.raises(ValueError, match="not interchangeable|do not resume"):
        exp._opt_from_blob(("step", "slots"))
