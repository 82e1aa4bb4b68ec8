"""The experiment lifecycle of the PyTorch/CUDA port against the JAX
reference on the CPU: the checkpoint format (byte for byte), rotation and
the generation fallback, the logger, the schedulers and optimizers, and the
federated entry points end to end -- checkpoint and best copy, resume
(modes 1 and 2, equal bit for bit to an uninterrupted run, dense and int8),
the restarted cohort stream, and each package evaluating the other's
checkpoint.  MNIST conv twin at hidden 8/16, synthetic data, 4 users at
levels a1-e1, 1 local epoch; the reference trains once per module."""

import json
import math
import os
import shutil
import sys
import warnings

import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu.entry import test_classifier_fed as r_test_fed
from heterofl_tpu.entry import train_classifier_fed as r_train_fed
from heterofl_tpu.entry.common import FedExperiment as RFedExperiment
from heterofl_tpu.ops.fused_update import FlatSpec as RFlatSpec
from heterofl_tpu.utils import checkpoint as rckpt
from heterofl_tpu.utils.logger import Logger as RLogger
from heterofl_tpu.utils.optim import PlateauScheduler as RPlateau
from heterofl_tpu.utils.optim import make_optimizer as r_make_optimizer
from heterofl_tpu.utils.optim import make_scheduler as r_make_scheduler
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.convert import flat_from_jax, flat_to_jax, params_to_jax
from heterofl_tpu_torch.entry import test_classifier_fed, train_classifier_fed
from heterofl_tpu_torch.entry.common import FedExperiment
from heterofl_tpu_torch.testing import assert_close, thread_limit_fixture
from heterofl_tpu_torch.utils import Logger, PlateauScheduler, make_optimizer, make_scheduler
from heterofl_tpu_torch.utils import checkpoint as ckpt

few_threads = thread_limit_fixture()

CONTROL = "1_4_0.5_iid_fix_a1-e1_bn_1_1"
TAG = f"0_MNIST_label_conv_{CONTROL}"
SIZES = '{"train": 200, "test": 40}'
TOL_EVAL = 1e-4  # the evaluator's stated tolerance (tests/test_torch_port_eval.py)


def _argv(out, rounds, *extra, port=True):
    """Flags of a training or test entry; the reference's cohorts under its
    legacy ``sampler='perm'`` (the port's only sampler)."""
    argv = ["--output_dir", str(out), "--control_name", CONTROL, "--data_name", "MNIST",
            "--model_name", "conv", "--synthetic", "1", "--synthetic_sizes", SIZES,
            "--override", json.dumps({"num_epochs": {"global": rounds, "local": 1},
                                      "conv": {"hidden_size": [8, 16]}}), *extra]
    return argv + (["--device", "cpu"] if port else ["--sampler", "perm"])


def _equal(a, b) -> bool:
    """Deep equality of two blobs (arrays by value and dtype)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


# --- the checkpoint format -------------------------------------------------------

def _numpy_blob(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"cfg": {"lr": 0.1, "control": {"fed": "1"}, "milestones": [100], "override": {}},
            "epoch": 3, "data_split": {"train": {0: [4, 1], 1: [0]}, "test": {0: [2], 1: [3]}},
            "label_split": {0: [0, 1], 1: [2]},
            "params": {"block0.conv.w": f32(3, 3, 1, 8), "block0.conv.b": f32(8),
                       "linear.w": f32(8, 10)},
            "bn_state": {"block0.norm": (f32(8), np.abs(f32(8)))},
            "wire_resid": f32(1, 1, 170), "sched_buf": None, "ledger": None, "pivot": -math.inf,
            "logger_history": {"test/Global-Accuracy": [10.0, 12.5]},
            "logger_state": {"counter": {"train/Local-Loss": 40.0}, "mean": {"train/Local-Loss": 2.25},
                             "history": {"test/Global-Accuracy": [10.0, 12.5]}, "iterator": {}},
            "scheduler_state": None}


def test_checkpoint_bytes_match_reference(tmp_path):
    """The same blob gives the same bytes through either package's
    ``_blob_bytes`` (magic, SHA-256, protocol-4 pickle), also when the port
    holds its tensors as torch tensors; each package loads the other's
    file."""
    blob = _numpy_blob()
    assert ckpt._blob_bytes(blob) == rckpt._blob_bytes(blob)
    as_torch = dict(blob, params={k: torch.from_numpy(v.copy()) for k, v in blob["params"].items()},
                    bn_state={k: tuple(torch.from_numpy(a.copy()) for a in v)
                              for k, v in blob["bn_state"].items()})
    assert ckpt._blob_bytes(as_torch) == rckpt._blob_bytes(blob)
    mine, theirs = str(tmp_path / "port.pkl"), str(tmp_path / "ref.pkl")
    ckpt.save_checkpoint(mine, as_torch)
    rckpt.save_checkpoint(theirs, blob)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert _equal(rckpt.load_checkpoint(mine), blob) and _equal(ckpt.load_checkpoint(theirs), blob)


def test_rotation_matches_reference(tmp_path):
    """``keep=3``: the live blob and two older generations, found by listing
    the directory, each file equal to the reference's rotation's."""
    gens = {}
    for name, mod in (("port", ckpt), ("ref", rckpt)):
        path = mod.checkpoint_path(str(tmp_path / name), "tag")
        for e in range(1, 5):
            mod.save_checkpoint(path, dict(_numpy_blob(e), epoch=e), keep=3)
        gens[name] = mod.generation_paths(path)
    assert [os.path.basename(p) for p in gens["port"]] == [
        "tag_checkpoint.pkl", "tag_checkpoint.pkl.g1", "tag_checkpoint.pkl.g2"]
    assert [ckpt.load_checkpoint(p)["epoch"] for p in gens["port"]] == [4, 3, 2]
    for a, b in zip(gens["port"], gens["ref"]):
        assert open(a, "rb").read() == open(b, "rb").read()


def _flip(path, offset=-5):
    raw = bytearray(open(path, "rb").read())
    raw[offset] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def test_corrupt_newest_generation_falls_back(tmp_path):
    """A flipped byte in the live blob: ``resume`` warns ``checkpoint-corrupt``
    and returns generation 1, as the reference's does on the same files; a
    truncated header is corrupt too."""
    out = str(tmp_path)
    path = ckpt.checkpoint_path(out, "tag")
    for e in (1, 2, 3):
        ckpt.save_checkpoint(path, dict(_numpy_blob(e), epoch=e), keep=3)
    _flip(path)
    with pytest.raises(ckpt.CheckpointCorruptError, match="SHA-256"):
        ckpt.load_checkpoint(path)
    with pytest.warns(UserWarning, match="checkpoint-corrupt"):
        assert ckpt.resume(out, "tag", 1)["epoch"] == 2
    with pytest.warns(UserWarning, match="checkpoint-corrupt"):
        assert rckpt.resume(out, "tag", 1)["epoch"] == 2
    open(path, "wb").write(ckpt.CHECKPOINT_MAGIC + b"\0" * 10)
    with pytest.raises(ckpt.CheckpointCorruptError, match="truncated"):
        ckpt.load_checkpoint(path)


def test_every_generation_corrupt_raises(tmp_path):
    out = str(tmp_path)
    path = ckpt.checkpoint_path(out, "tag")
    for e in (1, 2):
        ckpt.save_checkpoint(path, dict(_numpy_blob(e), epoch=e), keep=3)
    for p in ckpt.generation_paths(path):
        _flip(p)
    with pytest.warns(UserWarning, match="checkpoint-corrupt"):
        with pytest.raises(ckpt.CheckpointCorruptError, match="all 2"):
            ckpt.resume(out, "tag", 1)


def test_resume_modes_absent_and_weights_only(tmp_path):
    """Absent or mode 0 -> None; mode 2 -> params, bn_state and the splits
    only; ``copy_best`` copies the live blob's bytes."""
    out = str(tmp_path)
    assert ckpt.resume(out, "tag", 1) is None
    ckpt.save_checkpoint(ckpt.checkpoint_path(out, "tag"), _numpy_blob())
    assert ckpt.resume(out, "tag", 0) is None
    assert _equal(ckpt.resume(out, "tag", 1), _numpy_blob())
    weights = ckpt.resume(out, "tag", 2)
    assert sorted(weights) == ["bn_state", "data_split", "label_split", "params"]
    ckpt.copy_best(out, "tag")
    assert open(ckpt.checkpoint_path(out, "tag", "best"), "rb").read() == \
        open(ckpt.checkpoint_path(out, "tag"), "rb").read()


def test_flat_buffers_cross_layouts_exactly():
    """A flat buffer (the residual) in the port's layout -> the reference's
    equals the reference's ``FlatSpec`` over the converted leaves; the round
    trip is exact."""
    shapes = {"block0.conv.w": (8, 1, 3, 3), "block0.conv.b": (8,), "linear.w": (10, 8)}
    rng = np.random.default_rng(1)
    leaves = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    port_flat = torch.cat([leaves[k].reshape(-1) for k in sorted(shapes)]).numpy()
    ref = params_to_jax(leaves)
    ref_flat = np.asarray(RFlatSpec({k: v.shape for k, v in ref.items()}).flatten(ref))
    rows = np.stack([port_flat, 2 * port_flat])[None]
    np.testing.assert_array_equal(flat_to_jax(rows, shapes), np.stack([ref_flat, 2 * ref_flat])[None])
    np.testing.assert_array_equal(flat_from_jax(flat_to_jax(rows, shapes), shapes), rows)


# --- the logger, schedulers and optimizers -------------------------------------------

def _drive_logger(lg):
    lines = []
    for rnd in range(2):
        lg.safe(True)
        lg.append({"Local-Loss": 2.0 - rnd, "Local-Accuracy": 10.0}, "train", n=30)
        lg.append({"Local-Loss": 1.0, "Local-Accuracy": 40.0 + rnd}, "train", n=10)
        lg.append({"info": ["Model: x", f"Train Epoch: {rnd}", "Learning rate: 0.1"]}, "train",
                  mean=False)
        lines.append(lg.write("train", ["Local-Loss", "Local-Accuracy"]))
        lg.append({"Global-Loss": 1.5, "Global-Accuracy": 55.0 + rnd}, "test", n=40)
        lines.append(lg.write("test", ["Global-Loss", "Global-Accuracy", "missing"]))
        lg.emit({"event": "probe", "v": rnd})
        lg.reset_tag("test")
        lg.append({"Global-Loss": 0.5}, "test", n=4)
        lg.safe(False)
        state = lg.state_dict()
        lg.reset()
    return lines, state


def test_logger_matches_reference(tmp_path):
    """The same calls give the same lines, running means, history, state and
    JSONL records (but the wall-clock ``t``); the state round-trips."""
    port, ref = Logger(str(tmp_path / "port")), RLogger(str(tmp_path / "ref"))
    p_lines, p_state = _drive_logger(port)
    r_lines, r_state = _drive_logger(ref)
    assert p_lines == r_lines and p_state == r_state
    assert p_state["history"]["train/Local-Loss"] == [1.75, 1.0]
    recs = {}
    for name in ("port", "ref"):
        with open(tmp_path / name / "log.jsonl") as f:
            recs[name] = [{k: v for k, v in json.loads(line).items() if k != "t"} for line in f]
    assert recs["port"] == recs["ref"] and len(recs["port"]) == 6
    again = Logger(str(tmp_path / "again"))
    again.load_state_dict(p_state)
    assert again.state_dict() == p_state


def test_logger_warns_once_without_tensorboard(tmp_path, monkeypatch):
    """``use_tensorboard`` without a usable writer: one warning per logger,
    then JSONL-only logging."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = Logger(str(tmp_path), use_tensorboard=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            lg.safe(True)
            lg.append({"Loss": 1.0}, "train")
            lg.write("train", ["Loss"])
            lg.safe(False)
    assert len([w for w in caught if "tensorboard" in str(w.message)]) == 1
    assert lg.writer is None and len(open(tmp_path / "log.jsonl").readlines()) == 2


SCHED_BASE = {"lr": 0.1, "factor": 0.5, "milestones": [150, 250], "step_size": 30,
              "num_epochs": {"global": 400, "local": 5}, "patience": 3, "threshold": 1e-3,
              "min_lr": 1e-4}


@pytest.mark.parametrize("name", ["None", "StepLR", "MultiStepLR", "ExponentialLR",
                                  "CosineAnnealingLR", "CyclicLR", "ReduceLROnPlateau"])
def test_scheduler_matches_reference(name):
    """Every kind gives the reference's LR at each of 400 rounds (exact);
    the plateau kind fed the same test losses, its state round-tripping
    mid-run through ``state_dict`` (and equal to the reference's)."""
    cfg = dict(SCHED_BASE, scheduler_name=name)
    port, ref = make_scheduler(cfg), r_make_scheduler(cfg)
    losses = 2.0 / np.sqrt(np.arange(1, 401)) + 0.05 * np.sin(np.arange(400))
    got, want = [], []
    for e in range(1, 401):
        got.append(port(e))
        want.append(ref(e))
        if name == "ReduceLROnPlateau":
            port.step_metric(float(losses[e - 1]))
            ref.step_metric(float(losses[e - 1]))
            if e == 200:
                assert port.state_dict() == ref.state_dict()
                fresh = make_scheduler(cfg)
                fresh.load_state_dict(port.state_dict())
                port = fresh
    assert got == want
    if name == "ReduceLROnPlateau":
        assert isinstance(port, PlateauScheduler) and isinstance(ref, RPlateau)
        assert min(got) < max(got)  # the plateau engaged


@pytest.mark.parametrize("name", ["SGD", "RMSprop", "Adam", "Adamax"])
def test_optimizer_matches_reference(name):
    """Five updates over a dict of leaves: params and slots against the
    reference's ``make_optimizer`` to rtol 1e-6, atol 1e-7 (float32, the
    same expressions; a power may differ in its last ulp)."""
    import jax.numpy as jnp

    cfg = {"optimizer_name": name, "momentum": 0.9, "weight_decay": 5e-4}
    rng = np.random.default_rng(2)
    shapes = {"a.w": (4, 3), "a.b": (3,), "z": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    init, update = make_optimizer(cfg)
    r_init, r_update = r_make_optimizer(cfg)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    st, rst = init(p), r_init(rp)
    for step in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        p, st = update(p, {k: torch.from_numpy(v) for k, v in grads.items()}, st,
                       torch.tensor(0.01))
        rp, rst = r_update(rp, {k: jnp.asarray(v) for k, v in grads.items()}, rst, 0.01)
    assert st["step"] == int(rst.step) == 5
    flat = lambda d: np.concatenate([np.asarray(d[k]).ravel() for k in sorted(d)])  # noqa: E731
    assert_close(f"optimizer {name}: params", flat(p), flat(rp), rtol=1e-6, atol=1e-7)
    slots = st["slots"] if name == "SGD" else {f"{s}/{k}": v for s, d in st["slots"].items()
                                               for k, v in d.items()}
    r_slots = rst.slots if name == "SGD" else {f"{s}/{k}": v for s, d in rst.slots.items()
                                               for k, v in d.items()}
    assert_close(f"optimizer {name}: slots", flat(slots), flat(r_slots), rtol=1e-6, atol=1e-7)


def test_lifecycle_keys_are_ported():
    """``resume_mode``, ``use_tensorboard`` and ``checkpoint_keep`` pass the
    port's config; a malformed ``checkpoint_keep`` fails there, as the
    reference's validator does."""
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name(CONTROL)
    out = PC.process_control(dict(cfg, resume_mode=2, use_tensorboard=True, checkpoint_keep=5))
    assert (out["resume_mode"], out["use_tensorboard"], out["checkpoint_keep"]) == (2, True, 5)
    assert PC.resolve_checkpoint_keep(dict(cfg, checkpoint_keep=None)) == 3
    for bad in (0, "3", True, 1.5):
        with pytest.raises(ValueError, match="checkpoint_keep"):
            PC.process_control(dict(cfg, checkpoint_keep=bad))
        with pytest.raises(ValueError, match="checkpoint_keep"):
            RC.resolve_checkpoint_keep(dict(cfg, checkpoint_keep=bad))


# --- the entry points ------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Three dense rounds of the port's ``train_classifier_fed``, evaluated
    every round -> (output dir, result)."""
    out = tmp_path_factory.mktemp("port_run")
    (res,) = train_classifier_fed.main(_argv(out, 3))
    return out, res


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The same run through the reference's ``train_classifier_fed`` (its
    8-device CPU mesh) -> output dir."""
    out = tmp_path_factory.mktemp("ref_run")
    r_train_fed.main(_argv(out, 3, port=False))
    return out


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def test_entry_writes_checkpoint_and_best(port_run):
    """Each round writes ``_checkpoint.pkl`` (three generations kept) and a
    new best Global accuracy is copied to ``_best.pkl``; the blob has the
    reference's keys, params in its layout, no residual on the dense path."""
    out, res = port_run
    live = ckpt.checkpoint_path(str(out), TAG)
    assert len(ckpt.generation_paths(live)) == 3
    blob = ckpt.load_checkpoint(live)
    assert sorted(blob) == sorted(
        ["cfg", "epoch", "data_split", "label_split", "params", "bn_state", "wire_resid",
         "sched_buf", "ledger", "pivot", "logger_history", "logger_state", "scheduler_state"])
    assert blob["epoch"] == 4 and blob["wire_resid"] is None
    assert blob["params"]["block0.conv.w"].shape == (3, 3, 1, 8)  # HWIO
    acc = res["logger"].history["test/Global-Accuracy"]
    assert len(acc) == 3 and blob["pivot"] == max(acc)
    best = ckpt.load_checkpoint(ckpt.checkpoint_path(str(out), TAG, "best"))
    assert best["logger_history"]["test/Global-Accuracy"][-1] == max(acc)
    assert [r["epoch"] for r in res["history"]] == [1, 2, 3]
    assert all(r["checkpoint_mb"] > 0 and r["checkpoint_seconds"] >= 0 for r in res["history"])


def test_resume_with_no_rounds_left_carries_logger_state(port_run, tmp_path):
    """``resume_mode=1`` past the last round trains nothing and carries the
    logger state verbatim (running means, counters, step counters,
    history) -- the port's ``tests/test_entry.py::test_resume_logger_fidelity``."""
    out = _copy(port_run[0], tmp_path / "run")
    st = ckpt.load_checkpoint(ckpt.checkpoint_path(str(out), TAG))["logger_state"]
    assert st["counter"] and st["mean"] and len(st["history"]["test/Global-Accuracy"]) == 3
    (res,) = train_classifier_fed.main(_argv(out, 3, "--resume_mode", "1"))
    lg = res["logger"]
    assert res["history"] == []
    assert dict(lg.counter) == st["counter"] and dict(lg.mean) == st["mean"]
    assert dict(lg.iterator) == st["iterator"]
    assert {k: list(v) for k, v in lg.history.items()} == st["history"]


def test_resume_mode_2_reruns_rounds_from_the_params(port_run, tmp_path):
    """``resume_mode=2``: the params and the split of the blob, then rounds
    1..N again with a fresh logger."""
    out = _copy(port_run[0], tmp_path / "run")
    (res,) = train_classifier_fed.main(_argv(out, 2, "--resume_mode", "2"))
    assert [r["epoch"] for r in res["history"]] == [1, 2]
    assert len(res["logger"].history["test/Global-Accuracy"]) == 2
    assert res["data_split"] == port_run[1]["data_split"]


COHORTS = {1: [0, 3], 2: [2, 1], 3: [3, 1]}


@pytest.mark.parametrize("codec", ["dense", "int8"])
def test_resume_equals_uninterrupted(tmp_path, monkeypatch, codec):
    """Two rounds, a checkpoint, then a resumed third round equal bit for
    bit to three rounds in one run (the cohort pinned per round: a resumed
    run restarts the numpy stream): params, the error-feedback residual
    (int8; in the blob as the reference's ``[1, slots, total]`` carry) and
    the logger history."""
    monkeypatch.setattr(FedExperiment, "sample_users",
                        lambda self, epoch: np.array(COHORTS[epoch], np.int64))
    codec_flags = ("--wire_codec", codec)
    (full,) = train_classifier_fed.main(_argv(tmp_path / "full", 3, *codec_flags))
    train_classifier_fed.main(_argv(tmp_path / "cut", 2, *codec_flags))
    blob = ckpt.load_checkpoint(ckpt.checkpoint_path(str(tmp_path / "cut"), TAG))
    (res,) = train_classifier_fed.main(_argv(tmp_path / "cut", 3, *codec_flags,
                                             "--resume_mode", "1"))
    assert [r["epoch"] for r in res["history"]] == [3]
    for k, v in full["params"].items():
        assert torch.equal(res["params"][k], v), k
    if codec == "int8":
        assert blob["wire_resid"].shape[:2] == (1, 1) and np.any(blob["wire_resid"] != 0)
        np.testing.assert_array_equal(res["wire_resid"], full["wire_resid"])
    else:
        assert blob["wire_resid"] is None and res["wire_resid"] is None
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    assert hist(res) == hist(full) and len(hist(res)["train/Local-Loss"]) == 3


def test_resumed_perm_stream_matches_reference(port_run, tmp_path, monkeypatch):
    """From the same blob, the port's resumed cohorts of rounds 4-6 equal
    the reference ``FedExperiment``'s under ``sampler='perm'``: both skip
    the split draw and restart the numpy stream.  The reference's run
    resumes the port's blob with its round and evaluation stubbed out."""
    out = _copy(port_run[0], tmp_path / "port")
    ref_out = _copy(port_run[0], tmp_path / "ref")
    drawn, ref_drawn = {}, {}
    sample = FedExperiment.sample_users

    def record(self, epoch):
        drawn[epoch] = sample(self, epoch)
        return drawn[epoch]

    monkeypatch.setattr(FedExperiment, "sample_users", record)
    train_classifier_fed.main(_argv(out, 6, "--resume_mode", "1"))
    rcfg = RC.default_cfg()
    rcfg.update(control=RC.parse_control_name(CONTROL), data_name="MNIST", model_name="conv",
                synthetic=True, synthetic_sizes=json.loads(SIZES), output_dir=str(ref_out),
                resume_mode=1, sampler="perm",
                override={"num_epochs": {"global": 6, "local": 1},
                          "conv": {"hidden_size": [8, 16]}})
    rexp = RFedExperiment(RC.process_control(rcfg), 0)

    def ref_round(params, epoch, lr, logger):
        ref_drawn[epoch] = rexp.sample_users(epoch)
        return params

    rexp.train_round = ref_round
    rexp.evaluate = lambda params, epoch, logger, label_split: {}
    rexp.run("Global-Accuracy")
    assert sorted(drawn) == sorted(ref_drawn) == [4, 5, 6]
    for e in drawn:
        np.testing.assert_array_equal(drawn[e], ref_drawn[e])


def _logged_global(out):
    """The Global loss and accuracy the training log holds for the best
    checkpoint's round."""
    hist = ckpt.load_checkpoint(ckpt.checkpoint_path(str(out), TAG, "best"))["logger_history"]
    return hist["test/Global-Loss"][-1], hist["test/Global-Accuracy"][-1]


def test_port_evaluates_reference_checkpoint(ref_run, tmp_path):
    """The port's ``test_classifier_fed`` on the reference's best checkpoint
    reproduces the Global loss and accuracy the reference logged for it
    (rtol/atol 1e-4) and writes the result bundle."""
    out = _copy(ref_run, tmp_path / "run")
    loss, acc = _logged_global(out)
    (bundle,) = test_classifier_fed.main(_argv(out, 3))
    hist = bundle["logger_history"]
    assert_close("port evaluates the reference's checkpoint: Global-Loss",
                 hist["test/Global-Loss"][0], loss, rtol=TOL_EVAL, atol=TOL_EVAL)
    assert_close("port evaluates the reference's checkpoint: Global-Accuracy",
                 hist["test/Global-Accuracy"][0], acc, rtol=TOL_EVAL, atol=TOL_EVAL)
    assert os.path.exists(out / "result" / f"{TAG}.pkl")
    assert bundle["train_history"]["test/Global-Accuracy"][-1] == acc


def test_reference_evaluates_port_checkpoint(port_run, tmp_path):
    """The reverse: the reference's ``test_classifier_fed`` on the port's
    best checkpoint reproduces the port's logged Global loss and accuracy."""
    out = _copy(port_run[0], tmp_path / "run")
    loss, acc = _logged_global(out)
    (bundle,) = r_test_fed.main(_argv(out, 3, port=False))
    hist = bundle["logger_history"]
    assert_close("reference evaluates the port's checkpoint: Global-Loss",
                 hist["test/Global-Loss"][0], loss, rtol=TOL_EVAL, atol=TOL_EVAL)
    assert_close("reference evaluates the port's checkpoint: Global-Accuracy",
                 hist["test/Global-Accuracy"][0], acc, rtol=TOL_EVAL, atol=TOL_EVAL)
