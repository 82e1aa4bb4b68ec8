"""Experiment arms of the PyTorch/CUDA port on the CPU: the config, the
sweep front end and the arm streams (``heterofl_tpu_torch/multi/``,
``fed.core.arm_stream_seed``).

* ``resolve_arms_cfg``'s forms and every refusal -- malformed counts,
  seeds and scales, and the cross-field ones (``sliced``, ``ledger='on'``,
  ``trace_dir``, buffered aggregation, ``client_store='stream'``; under
  ``grouped`` a lossy codec, probes, the gate, ``level_placement='slices'``)
  -- against the JAX package's on the same inputs: the same spec, or the
  same message; ``process_control`` applies it;
* ``partition_grid``, ``arms_cfg_of``, ``launch_cfg`` and the ``--dry_run``
  output against the reference's for the same grid; a sweep run on the
  CPU, each launch under its own ``launch{i:03d}``;
* the arm streams: the identity arm is the run's stream, distinct seeds
  give distinct streams and cohorts;
* the refusals of the experiment loops and engines: the one-trajectory loop, the
  watchdog's rollback, the K=1 rounds, a streamed cohort.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from heterofl_tpu import config as RC
from heterofl_tpu import multi as RM
from heterofl_tpu.multi import sweep as RS
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch import multi as PM
from heterofl_tpu_torch.entry.common import ArmsExperiment, FedExperiment
from heterofl_tpu_torch.fed.core import (ARM_STREAM_SALT, arm_stream_seed, arm_stream_seeds,
                                         round_seed, superstep_user_schedule)
from heterofl_tpu_torch.multi import sweep as PS
from heterofl_tpu_torch.parallel import GroupedRoundEngine, RoundEngine
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

RAW_ARMS = [
    None, 1, 3, {"count": 2}, {"count": 2, "seeds": [7, None], "lr_scales": [0.5, 2]},
    {"count": 3, "seeds": [None, None, 0], "lr_scales": [1, 1.5, 0.25]},
    # malformed
    True, 0, -2, PM.MAX_ARMS + 1, "4", 2.0, [2], {"count": 2, "bogus": 1}, {"seeds": [1]},
    {"count": True}, {"count": 2, "seeds": [1]}, {"count": 2, "seeds": [1, -3]},
    {"count": 2, "seeds": [1, True]}, {"count": 2, "seeds": [1, 2.0]},
    {"count": 2, "lr_scales": [1.0]}, {"count": 2, "lr_scales": [1.0, 0.0]},
    {"count": 2, "lr_scales": [1.0, -1.0]}, {"count": 2, "lr_scales": [1.0, True]},
    {"count": 2, "lr_scales": [1.0, "2"]},
]

CROSS = [
    {"strategy": "sliced"},
    {"ledger": "on"},
    {"trace_dir": "/tmp/t"},
    {"schedule": {"kind": "uniform", "aggregation": "buffered"}},
    {"client_store": "stream"},
    {"strategy": "grouped", "wire_codec": "int8"},
    {"strategy": "grouped", "wire_codec": {"1": "dense", "0.5": "int8"}},
    {"strategy": "grouped", "wire_codec": {"1": "dense", "0.5": "dense"}},
    {"strategy": "grouped", "telemetry": "on"},
    {"strategy": "grouped", "quarantine": "on"},
    {"strategy": "grouped", "level_placement": "slices"},
    {"strategy": "masked", "wire_codec": "int8", "telemetry": "hist", "quarantine": "on"},
    {"strategy": "grouped"},
]


def _spec(mod, cfg):
    try:
        spec = mod.resolve_arms_cfg(cfg)
    except ValueError as e:
        return "error", str(e)
    return "spec", None if spec is None else (spec.count, spec.seeds, spec.lr_scales)


@pytest.mark.parametrize("raw", RAW_ARMS, ids=[repr(r) for r in RAW_ARMS])
def test_resolve_arms_cfg_matches_reference(raw):
    """Every accepted form gives the reference's spec; every malformed one
    its message."""
    assert _spec(PM, {"arms": raw}) == _spec(RM, {"arms": raw})


@pytest.mark.parametrize("over", CROSS, ids=[json.dumps(c) for c in CROSS])
def test_arms_cross_refusals_match_reference(over):
    cfg = dict(over, arms=2)
    assert _spec(PM, cfg) == _spec(RM, cfg)


def test_arms_spec_solo_default_seeds_and_bound():
    spec = PM.resolve_arms_cfg({"arms": {"count": 2, "seeds": [7, None], "lr_scales": [0.5, 2]}})
    assert spec.solo(0) == PM.ArmsSpec(1, (7,), (0.5,))
    assert hash(spec.solo(1)) == hash(PM.ArmsSpec(1, (None,), (2.0,)))
    assert PM.default_seeds(3) == RM.default_seeds(3) == (None, 1, 2)
    assert PM.MAX_ARMS == RM.MAX_ARMS


def _control_cfg(mod, **over):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name("1_8_0.5_iid_fix_a1-b1_bn_1_1")
    cfg.update(data_name="MNIST", model_name="conv", **over)
    return cfg


@pytest.mark.parametrize("arms", [{"count": 0}, 2, {"count": 2, "seeds": [None, 3]}])
def test_process_control_validates_arms(arms):
    """``arms`` is ported (out of ``UNPORTED``) and validated last, as the
    reference's ``process_control`` does."""
    assert "arms" not in PC.UNPORTED and PC.DEFAULT_CFG["arms"] is None
    assert "level_placement" not in PC.UNPORTED  # the grouped engine on the mesh
    assert not {"world_size", "data_placement"} & set(PC.UNPORTED)  # the clients mesh axis

    def run(mod):
        try:
            return "ok", mod.process_control(_control_cfg(mod, arms=arms))["arms"]
        except ValueError as e:
            return "error", str(e)

    assert run(PC) == run(RC)


GRIDS = [
    ({"seed": [0, 1], "lr": [0.1, 0.01], "wire_codec": ["dense", "int8"]}, 8),
    ({"seed": list(range(5))}, 2),
    ({"init_seed": [3, 4], "strategy": ["masked", "grouped"], "superstep_rounds": [1, 2]}, 8),
    ({"lr": [0.1, 0.03, 0.01]}, 1),
    ({"wire_codec": ["int8"]}, 4),
]
BAD_GRIDS = [({}, 2), ([1], 2), ({"seed": []}, 2), ({"seed": [0], "init_seed": [1]}, 2),
             ({"seed": [-1]}, 2), ({"seed": [True]}, 2), ({"lr": [0]}, 2), ({"lr": ["x"]}, 2),
             ({"seed": [0]}, 0), ({"seed": [0]}, PM.MAX_ARMS + 1)]


def _partition(mod, grid, max_arms):
    try:
        return "ok", mod.partition_grid(grid, max_arms=max_arms)
    except ValueError as e:
        return "error", str(e)


@pytest.mark.parametrize("grid,max_arms", GRIDS + BAD_GRIDS,
                         ids=[json.dumps(g) + f"/{m}" for g, m in GRIDS + BAD_GRIDS])
def test_partition_grid_matches_reference(grid, max_arms):
    assert _partition(PS, grid, max_arms) == _partition(RS, grid, max_arms)


@pytest.mark.parametrize("grid,max_arms", GRIDS, ids=[json.dumps(g) for g, _ in GRIDS])
def test_launch_cfg_and_arms_cfg_of_match_reference(tmp_path, grid, max_arms):
    """Each launch's arms, its structural overrides and its own output root,
    and the describe line, from both packages' ``launch_cfg``."""
    base_p = _control_cfg(PC, output_dir=str(tmp_path))
    base_r = _control_cfg(RC, output_dir=str(tmp_path))
    for i, (struct, batch) in enumerate(PS.partition_grid(grid, max_arms=max_arms)):
        p, r = PS.launch_cfg(base_p, i, struct, batch), RS.launch_cfg(base_r, i, struct, batch)
        assert p["arms"] == r["arms"] == RS.arms_cfg_of(r, batch) == PS.arms_cfg_of(p, batch)
        assert p["output_dir"] == r["output_dir"] == os.path.join(str(tmp_path),
                                                                  f"launch{i:03d}")
        assert all(p[k] == r[k] == v for k, v in struct.items())
        assert PS.describe_launch(i, struct, batch) == RS.describe_launch(i, struct, batch)
        assert PM.resolve_arms_cfg(p) == PM.resolve_arms_cfg(dict(p, arms=r["arms"]))


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_sweep_dry_run_matches_reference():
    argv = ["--control_name", "1_8_0.5_iid_fix_a1-b1_bn_1_1", "--data_name", "MNIST",
            "--model_name", "conv", "--max_arms", "3", "--dry_run", "1", "--grid",
            json.dumps({"seed": [0, 1], "lr": [0.1, 0.05], "wire_codec": ["dense", "int8"]})]
    rc, out = _stdout(PS.main, ["--device", "cpu"] + argv)
    rc_ref, out_ref = _stdout(RS.main, argv)
    assert rc == rc_ref == 0 and out == out_ref and out.count("launch ") == 4
    with pytest.raises(ValueError, match="Not valid structural grid key"):
        PS.main(["--device", "cpu", "--dry_run", "1", "--grid", '{"bogus": [1]}'])
    if not torch.cuda.is_available():  # cuda (the default) on a host without one
        with pytest.raises(RuntimeError, match="--device cpu"):
            PS.main(argv)


def test_sweep_runs_each_launch_in_its_own_root(tmp_path):
    """Two structural launches of two arms each on the CPU: each writes its
    multiplexed blob, its arms' checkpoints and its log under its root."""
    argv = ["--device", "cpu", "--control_name", "1_8_0.5_iid_fix_a1-b1_bn_1_1",
            "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
            "--synthetic_sizes", json.dumps({"train": 80, "test": 40}),
            "--output_dir", str(tmp_path), "--superstep_rounds", "2",
            "--override", json.dumps({"num_epochs": {"global": 2, "local": 1},
                                      "conv": {"hidden_size": [4, 8]}}),
            "--grid", json.dumps({"seed": [0, 1], "wire_codec": ["dense", "int8"]})]
    rc, out = _stdout(PS.main, argv)
    assert rc == 0 and out.count("sweep: running") == 2
    tag = "0_MNIST_label_conv_1_8_0.5_iid_fix_a1-b1_bn_1_1_arms2"
    for i in range(2):
        files = os.listdir(os.path.join(str(tmp_path), f"launch{i:03d}", "model"))
        assert {f"{tag}_checkpoint.pkl", f"{tag}_a0_checkpoint.pkl",
                f"{tag}_a1_checkpoint.pkl"} <= set(files)
        log = os.path.join(str(tmp_path), f"launch{i:03d}", "runs", f"train_{tag}", "log.jsonl")
        lines = [json.loads(line) for line in open(log)]
        assert sorted({(r["arm"], r["epoch"]) for r in lines if r.get("event") == "train"}) \
            == [(0, 1), (0, 2), (1, 1), (1, 2)]


def test_arm_streams():
    """The identity arm's root is the run's seed; an arm's root is
    (seed, salt, arm seed)'s, distinct across arm seeds and from every round
    seed; distinct roots draw distinct cohorts."""
    assert arm_stream_seed(5, None) == 5
    roots = arm_stream_seeds(5, [None, 1, 2, 1])
    assert roots[0] == 5 and roots[1] == roots[3] and len({5, roots[1], roots[2]}) == 3
    assert roots[1] == int(np.random.SeedSequence([5, ARM_STREAM_SALT, 1]).generate_state(1)[0])
    assert ARM_STREAM_SALT == 0x4152
    assert not {roots[1], roots[2]} & {round_seed(5, e) for e in range(1, 200)}
    a = superstep_user_schedule(roots[1], 1, 4, 100, 10, "prp")
    b = superstep_user_schedule(roots[2], 1, 4, 100, 10, "prp")
    c = superstep_user_schedule(5, 1, 4, 100, 10, "prp")
    assert not np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.array_equal(superstep_user_schedule(roots[0], 1, 4, 100, 10, "prp"), c)


def _run_cfg(out, **over):
    return PC.process_control(_control_cfg(
        PC, synthetic=True, device="cpu", synthetic_sizes={"train": 80, "test": 40},
        output_dir=str(out), superstep_rounds=2,
        override={"num_epochs": {"global": 2, "local": 1}, "conv": {"hidden_size": [4, 8]}},
        **over))


def test_loops_refuse_what_they_cannot_run(tmp_path):
    """The one-trajectory loop refuses an arms cfg; the arms loop refuses a
    cfg without arms and the watchdog's rollback, with the reference's
    messages."""
    with pytest.raises(ValueError, match="needs the multiplexed driver loop"):
        FedExperiment(_run_cfg(tmp_path, arms=2), 0)
    with pytest.raises(ValueError, match="ArmsExperiment needs cfg"):
        ArmsExperiment(_run_cfg(tmp_path), 0)
    with pytest.raises(ValueError, match="action='rollback' cannot combine with arms"):
        ArmsExperiment(_run_cfg(tmp_path, arms=2, telemetry="on",
                                watchdog={"action": "rollback"}), 0)


@pytest.mark.parametrize("engine", [RoundEngine, GroupedRoundEngine])
def test_engines_refuse_k1_rounds_and_cohorts(tmp_path, engine):
    exp = ArmsExperiment(_run_cfg(tmp_path, arms=2), 0)
    cfg = exp.cfg
    eng = engine(exp.model, cfg, torch.device("cpu"))
    P = eng.flatten(exp.model.params())
    with pytest.raises(ValueError, match="arms need the fused superstep"):
        eng.train_round(P, 0.1, [0, 1], None, 0)
    with pytest.raises(ValueError, match="arms need the eager data path"):
        eng.train_superstep(torch.stack([P, P]), 0, 1, 1, None, np.zeros((1, 2), np.int64),
                            np.ones((1, 2), np.float32), [0.1], cohort=object())
    with pytest.raises(ValueError, match="client_store='stream'"):
        engine(exp.model, dict(cfg, client_store="stream"), torch.device("cpu"))
