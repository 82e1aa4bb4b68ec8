"""The K-round superstep of the PyTorch/CUDA port on the CPU: the masked
and the grouped engine's ``train_superstep`` against k sequential rounds
of the same engine, bit for bit (vision and LM, fixed and dynamic rates,
dense and int8), the static-buffer step against ``local_train``, the fused
evaluation against the host evaluation, and the experiment loop at
``superstep_rounds=2`` against the K=1 loop: logs, params and the
checkpoint at each superstep boundary, and a resumed superstep run against
an uninterrupted one.  On the CPU each captured step runs eagerly on the
same static buffers (``parallel/step_graph.py``); the reference's own
superstep is held to its K=1 rounds the same way (tests/test_superstep.py).
Small widths: the conv twin at 8/16, ResNet-18 at 8/16/16/16 on 120
CIFAR10 images, a one-layer transformer of embedding 128."""

import json
import math

import numpy as np
import pytest
import torch

from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.entry import train_classifier_fed
from heterofl_tpu_torch.entry.common import FedExperiment
from heterofl_tpu_torch.fed.core import (round_seed, superstep_rate_schedule,
                                         superstep_user_schedule)
from heterofl_tpu_torch.parallel import client_seed
from heterofl_tpu_torch.testing import thread_limit_fixture
from heterofl_tpu_torch.utils import checkpoint_path, load_checkpoint
from heterofl_tpu_torch.utils.checkpoint import generation_path
from heterofl_tpu_torch.utils.optim import superstep_lrs

# Every test here runs under PyTorch's deterministic algorithms: on the CPU
# an LM round alone differs from itself run to run (about 1e-8 on params:
# the accumulate into the token embedding's gradient over repeated tokens),
# so no two runs of it could be held bit for bit.
deterministic = thread_limit_fixture(deterministic=True)


DATA = {"conv": "MNIST", "resnet18": "CIFAR10", "transformer": "WikiText2"}
SMALL = {"num_epochs": {"global": 3, "local": 1}, "conv": {"hidden_size": [8, 16]},
         "resnet": {"hidden_size": [8, 16, 16, 16]}, "bptt": 16,
         "transformer": {"embedding_size": 128, "num_heads": 2, "hidden_size": 64,
                         "num_layers": 1, "dropout": 0.2}}


def _experiment(model_name, control, strategy="masked", codec="dense", sampler="prp"):
    cfg = PC.default_cfg()
    cfg["control"] = PC.parse_control_name(control)
    sizes = {"train": 2000, "test": 400} if model_name == "transformer" else \
        {"train": 120, "test": 40}
    cfg.update(data_name=DATA[model_name], model_name=model_name, device="cpu", synthetic=True,
               synthetic_sizes=sizes, wire_codec=codec, strategy=strategy, superstep_rounds=2,
               pallas_norm=True, sampler=sampler, override=SMALL)
    exp = FedExperiment(PC.process_control(cfg), 0)
    exp.stage(*exp.make_splits())
    return exp


def _bits(what, a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    diff = float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0
    rel = diff / max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
    print(f"parity {what}: max_abs_err {diff:.3e} max_rel_err {rel:.3e}")
    assert a.shape == b.shape and torch.equal(a, b), what


CASES = {
    "masked conv dense": ("conv", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "dense"),
    "masked conv int8": ("conv", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "int8"),
    "masked resnet18 dynamic": ("resnet18", "1_4_1_iid_dynamic_a1-c1-e1_bn_1_1", "masked",
                                "dense"),
    "masked transformer": ("transformer", "1_4_1_iid_fix_a1-e1_bn_1_1", "masked", "dense"),
    "grouped conv dense": ("conv", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped", "dense"),
    "grouped conv int8": ("conv", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped", "int8"),
    "grouped resnet18 int8": ("resnet18", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped", "int8"),
    "grouped transformer": ("transformer", "1_6_1_iid_fix_a2-c2-e2_bn_1_1", "grouped", "dense"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_superstep_equals_sequential_rounds(case):
    """``train_superstep`` over k = 2 rounds with an evaluation fused after
    the second equals two sequential rounds of the same engine bit for bit:
    params, each round's per-client sums, the int8 codec's residual; and
    the fused evaluation equals the host evaluation of the same params.
    The grouped engine's K=1 round refuses a lossy codec, so its int8
    rounds go through the engine's round body (``_train_round``), which the
    K=1 round runs, with the codec's grid sized for the superstep's slots
    (``codec_slots``); tests/test_torch_port_grouped_superstep.py holds the
    grouped int8 superstep against the reference's."""
    model_name, control, strategy, codec = CASES[case]
    exp = _experiment(model_name, control, strategy, codec)
    eng, cfg, k = exp.engine, exp.cfg, 2
    A = 4
    users = superstep_user_schedule(0, 1, k, cfg["num_users"], A, "prp")
    rates = superstep_rate_schedule(0, 1, k, cfg, users)
    lrs = superstep_lrs(exp.scheduler, 1, k)
    assert len(set(rates.reshape(-1).tolist())) > 1, "the schedule should mix levels"
    P0 = eng.flatten(exp.model.params())
    P, seq = P0.clone(), []
    for r in range(k):
        rs = round_seed(0, 1 + r)
        if strategy == "grouped":
            P, ms = eng._train_round(P, float(lrs[r]), users[r], exp.train_data, rs, None, None,
                                     rates[r], None, codec_slots=eng.codec_slots(rates))
        else:
            P, ms = eng.train_round(P, float(lrs[r]), users[r], exp.train_data, rs,
                                    rates=rates[r])
        seq.append(ms)
    resid = eng.wire_resid_host()
    eng.reset_carries()
    fused = exp._fused_eval()
    P2, pending = eng.train_superstep(P0.clone(), 0, 1, k, exp.train_data, users, rates, lrs,
                                      [False, True], fused)
    out = pending.fetch()
    _bits(f"superstep {case}: params after {k} rounds", P2, P)
    for r in range(k):
        for name in ("loss_sum", "score_sum", "n"):
            _bits(f"superstep {case}: round {r + 1} {name}", out["train"][r][name],
                  seq[r][name])
        assert np.array_equal(out["train"][r]["rate"], seq[r]["rate"])
    if codec != "dense":
        _bits(f"superstep {case}: residual", eng.wire_resid_host(), resid)
    (ev,) = out["eval"]
    assert ev["epoch"] == 2 and len(pending.seconds["train"]) == k
    params = eng.unflatten(P2)
    if model_name != "transformer":
        bn = exp.evaluator.sbn_stats(params, *exp.sbn_batches)
        for site, (m, v) in bn.items():
            _bits(f"fused eval {case}: sBN {site}", np.stack(ev["bn"][site]),
                  torch.stack([m, v]))
        local = exp.evaluator.eval_users(params, bn, *exp.local_eval)
        for name, v in local.items():
            _bits(f"fused eval {case}: Local {name}", ev["local"][name], v)
    else:
        bn = {}
    glob = exp.evaluator.eval_global(params, bn, *exp.global_eval, epoch=2)
    assert ev["global"] == glob, (ev["global"], glob)


@pytest.mark.parametrize("model_name", ["resnet18", "transformer"])
def test_static_step_equals_local_train(model_name):
    """One client through the superstep's path -- its static buffers set up
    eagerly, then each step through the captured step function (eager on
    the CPU) -- equals ``local_train`` / ``local_train_lm`` on the same
    client and generator seed, bit for bit, at levels a and e."""
    exp = _experiment(model_name, "1_4_1_iid_fix_a1-e1_bn_1_1")
    eng, data = exp.engine, exp.train_data
    P = eng.flatten(exp.model.params())
    lr = torch.full((), 0.05, dtype=torch.float32)
    for wr, uid in ((1.0, 0), (0.0625, 3)):
        seed = client_seed(round_seed(0, 1), uid)
        gen = torch.Generator().manual_seed(seed)
        if model_name == "transformer":
            p, acc = eng.local_train_lm(P, wr, data[0][uid], data[-1][uid], gen, lr)
        else:
            p, acc = eng.local_train(P, wr, data[0][uid], data[1][uid], data[2][uid],
                                     data[-1][uid], gen, lr)
        step, st = eng.client_step(wr, P, data)
        eng.stage_client(st, P, wr, uid, data, seed)
        st["lr"].copy_(lr)
        for _ in range(st["steps"]):
            step.replay()
        _bits(f"static step {model_name} width {wr}: params", st["p"], p)
        _bits(f"static step {model_name} width {wr}: sums", st["acc"], acc)


def _argv(out, rounds, *extra):
    return ["--device", "cpu", "--output_dir", str(out), "--control_name",
            "1_4_0.5_iid_fix_a1-e1_bn_1_1", "--data_name", "MNIST", "--model_name", "conv",
            "--synthetic", "1", "--synthetic_sizes", '{"train": 120, "test": 40}',
            "--eval_interval", "2", "--override",
            json.dumps({"num_epochs": {"global": rounds, "local": 1},
                        "conv": {"hidden_size": [8, 16]}}), *extra]


TAG = "0_MNIST_label_conv_1_4_0.5_iid_fix_a1-e1_bn_1_1"
BLOB_KEYS = ("epoch", "params", "wire_resid", "pivot", "logger_history", "logger_state",
             "scheduler_state", "data_split", "label_split")


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(_same(a[k], b[k])
                                                                     for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray) or torch.is_tensor(a):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("sampler,codec", [("perm", "int8"), ("prp", "dense")])
def test_entry_superstep_equals_k1(tmp_path, sampler, codec):
    """``train_classifier_fed --superstep_rounds 2`` over 3 rounds (a
    superstep of 2, then the clamped tail of 1; evaluations at rounds 2 and
    3 fused into them) equals the K=1 run: the cohorts, every logged
    metric, the params, and the checkpoint at each superstep boundary
    (rounds 2 and 3) equals the K=1 run's at the same round."""
    extra = ("--sampler", sampler, "--wire_codec", codec)
    (k1,) = train_classifier_fed.main(_argv(tmp_path / "k1", 3, *extra))
    (k2,) = train_classifier_fed.main(_argv(tmp_path / "k2", 3, *extra,
                                            "--superstep_rounds", "2"))
    assert [r["users"] for r in k2["history"]] == [r["users"] for r in k1["history"]]
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    assert hist(k2) == hist(k1) and len(hist(k1)["train/Local-Loss"]) == 3
    for name in ("loss", "accuracy", "n", "Global-Accuracy", "Local-Accuracy"):
        assert [r.get(name) for r in k2["history"]] == [r.get(name) for r in k1["history"]]
    for k, v in k1["params"].items():
        _bits(f"entry K=2 vs K=1 ({sampler}, {codec}): {k}", k2["params"][k], v)
    live = lambda run: checkpoint_path(str(tmp_path / run), TAG)  # noqa: E731
    for gen in (0, 1):  # round 3 (the live blob), round 2 (one generation older)
        a = load_checkpoint(generation_path(live("k2"), gen) if gen else live("k2"))
        b = load_checkpoint(generation_path(live("k1"), gen) if gen else live("k1"))
        assert a["epoch"] == b["epoch"] == 4 - gen
        for key in BLOB_KEYS + ("bn_state",):
            assert _same(a[key], b[key]), (gen, key)
    assert "sampler_state" in a and "sampler_state" not in b


@pytest.mark.parametrize("strategy,codec", [("masked", "dense"), ("grouped", "int8")])
def test_entry_superstep_resume_equals_uninterrupted(tmp_path, strategy, codec):
    """Four rounds at ``superstep_rounds=2`` (``perm``: the numpy stream)
    in one run, and two rounds then a resumed run to four: the resumed run
    restarts at the superstep boundary, draws the uninterrupted run's
    cohorts (the stream's state is in the checkpoint) and ends equal to it
    bit for bit -- params, residual, log; the grouped engine compresses
    with int8 in its superstep."""
    extra = ("--superstep_rounds", "2", "--strategy", strategy, "--wire_codec", codec,
             "--pallas_norm", "1")
    (full,) = train_classifier_fed.main(_argv(tmp_path / "full", 4, *extra))
    train_classifier_fed.main(_argv(tmp_path / "cut", 2, *extra))
    (res,) = train_classifier_fed.main(_argv(tmp_path / "cut", 4, *extra, "--resume_mode", "1"))
    assert [r["epoch"] for r in res["history"]] == [3, 4]
    assert [r["users"] for r in res["history"]] == [r["users"] for r in full["history"][2:]]
    for k, v in full["params"].items():
        _bits(f"resumed superstep ({strategy}, {codec}): {k}", res["params"][k], v)
    if codec != "dense":
        _bits(f"resumed superstep ({strategy}, {codec}): residual", res["wire_resid"],
              full["wire_resid"])
    hist = lambda r: {k: list(v) for k, v in r["logger"].history.items()}  # noqa: E731
    assert hist(res) == hist(full) and len(hist(full)["train/Local-Loss"]) == 4
    assert all(math.isfinite(r["loss"]) for r in full["history"])


def test_k1_metrics_fetch_every_defers_the_log(tmp_path):
    """At ``superstep_rounds=1``, ``metrics_fetch_every=2`` leaves each
    round's sums on the device and logs them when two are pending, before
    an evaluation or at the end: every round is logged with the values of
    a synchronous run, in order, and the params are the same."""
    extra = ("--eval_interval", "3")
    (sync,) = train_classifier_fed.main(_argv(tmp_path / "sync", 3, *extra))
    (lazy,) = train_classifier_fed.main(_argv(tmp_path / "lazy", 3, *extra,
                                              "--metrics_fetch_every", "2"))
    keys = ("epoch", "loss", "accuracy", "n", "users", "Global-Accuracy")
    assert [[r.get(k) for k in keys] for r in lazy["history"]] == \
        [[r.get(k) for k in keys] for r in sync["history"]]
    for k, v in sync["params"].items():
        assert torch.equal(lazy["params"][k], v), k
