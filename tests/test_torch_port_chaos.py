"""The chaos harness of the PyTorch/CUDA port on the CPU (``heterofl_tpu_torch/
chaos/``): fault plans, the injector, checkpoint corruption and the drill.

* ``resolve_fault_plan`` and ``resolve_poison_cfg`` against the JAX
  package's on the same raw inputs: the same plan, or the same message;
* the injector's counters, its kill a ``BaseException``;
* ``corrupt_blob`` on a port checkpoint: the load raises
  ``CheckpointCorruptError``, ``resume`` falls back a generation with the
  ``checkpoint-corrupt`` warning, and the corrupt drill lands on the
  uninterrupted run bit for bit;
* the kill matrix of the reference's ``tests/test_chaos.py:539-556``,
  widened to every point under both stores: ``masked`` and ``grouped``,
  ``eager`` and ``stream``, kills at ``superstep``, ``fetch``,
  ``checkpoint`` and (streamed) ``prefetch``, each resumed run's final
  params equal to the uninterrupted run's bit for bit;
* the poison drills, ``quarantine`` and ``rollback``, on both engines, the
  poisoned uid picked from the port's own streams;
* ``python -m heterofl_tpu_torch.chaos.drill --device cpu --json`` exits 0.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from heterofl_tpu import chaos as RCH
from heterofl_tpu_torch import chaos as PCH
from heterofl_tpu_torch.chaos import ChaosKill, FaultInjector, corrupt_blob, resolve_fault_plan
from heterofl_tpu_torch.chaos.drill import (drill_cfg, pick_poison_uid, run_kill_drill,
                                            run_poison_drill)
from heterofl_tpu_torch.entry.common import salt_seed
from heterofl_tpu_torch.fed.core import round_seed, round_users
from heterofl_tpu_torch.obs.watchdog import RETRY_SALT
from heterofl_tpu_torch.testing import thread_limit_fixture
from heterofl_tpu_torch.utils.checkpoint import (CheckpointCorruptError, checkpoint_path,
                                                 generation_path, load_checkpoint, resume,
                                                 save_checkpoint)

few_threads = thread_limit_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLANS = [
    {},
    {"kills": [{"point": "superstep", "at": 2}, {"point": "fetch"}]},
    {"kills": [{"point": "prefetch", "at": 1}], "corrupt": [{"which": "best", "mode": "truncate",
                                                           "generation": 1}]},
    {"corrupt": [{}], "poison": [[3, 1], [4, 0]]},
    # malformed: each refused with the reference's message
    [],
    "kills",
    {"bogus": 1},
    {"kills": [{"point": "superstep", "at": 1, "extra": 0}]},
    {"kills": ["superstep"]},
    {"kills": [{"point": "dispatch"}]},
    {"kills": [{"point": "fetch", "at": 0}]},
    {"kills": [{"point": "fetch", "at": True}]},
    {"kills": [{"point": "fetch", "at": 1.5}]},
    {"corrupt": [{"which": "checkpoint", "bogus": 1}]},
    {"corrupt": [{"which": "model"}]},
    {"corrupt": [{"mode": "zero"}]},
    {"corrupt": [{"generation": -1}]},
    {"corrupt": [{"generation": False}]},
    {"corrupt": ["flip"]},
    {"poison": []},
    {"poison": [[1]]},
    {"poison": [[-1, 0]]},
    {"poison": [[1, True]]},
]


def _resolve(mod, raw):
    try:
        plan = mod.resolve_fault_plan(raw)
    except ValueError as e:
        return "error", str(e)
    poison = None if plan.poison is None else plan.poison.tolist()
    return "plan", (plan.kills, plan.corrupt, poison, plan.n_kills)


@pytest.mark.parametrize("raw", PLANS, ids=[json.dumps(p) for p in PLANS])
def test_fault_plan_matches_reference(raw):
    """The same plan from the same raw dict, or the same refusal."""
    assert _resolve(PCH, raw) == _resolve(RCH, raw)


@pytest.mark.parametrize("raw", [None, [[3, 1]], [], [[1]], [[1, -2]], [[1.5, 0]], "3,1"])
@pytest.mark.parametrize("strategy", ["masked", "sliced"])
def test_poison_table_matches_reference(raw, strategy):
    cfg = {"chaos_poison": raw, "strategy": strategy}

    def table(mod):
        try:
            t = mod.resolve_poison_cfg(cfg)
        except ValueError as e:
            return str(e)
        return None if t is None else (t.dtype.name, t.tolist())

    assert table(PCH) == table(RCH)


def test_kill_points_and_modes_are_the_reference():
    assert PCH.KILL_POINTS == RCH.KILL_POINTS
    assert PCH.CORRUPT_MODES == RCH.CORRUPT_MODES


def test_injector_counts_kills_and_survives_them():
    """Counters run on across kills; the kill is a ``BaseException`` no
    ``except Exception`` sees; an unknown point raises."""
    inj = FaultInjector(resolve_fault_plan({"kills": [{"point": "fetch", "at": 2},
                                                      {"point": "fetch", "at": 4}]}))
    inj.check("fetch")
    with pytest.raises(ChaosKill) as info:
        try:
            inj.check("fetch")
        except Exception:  # noqa: BLE001 - what the code under test may write
            pytest.fail("a ChaosKill was caught as an Exception")
    assert (info.value.point, info.value.occurrence) == ("fetch", 2)
    inj.check("fetch")
    inj.check("superstep")
    with pytest.raises(ChaosKill, match="occurrence 4"):
        inj.check("fetch")
    assert inj.fired == [("fetch", 2), ("fetch", 4)]
    assert inj.counts == {"superstep": 1, "fetch": 4, "checkpoint": 0, "prefetch": 0}
    with pytest.raises(ValueError, match="unknown chaos point"):
        inj.check("dispatch")
    assert not issubclass(ChaosKill, Exception) and issubclass(ChaosKill, BaseException)


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_corrupt_blob_raises_and_resume_falls_back(tmp_path, mode):
    """Three generations written; the live one corrupted: its load raises
    ``CheckpointCorruptError`` and ``resume`` warns and returns the one
    before it."""
    out, tag = str(tmp_path), "t"
    path = checkpoint_path(out, tag)
    for epoch in (2, 3, 4):
        save_checkpoint(path, {"epoch": epoch, "params": {"w": np.full(64, epoch, np.float32)}},
                        keep=3)
    rec = corrupt_blob(path, mode)
    shrunk = rec["bytes_after"] < rec["bytes_before"]
    assert rec["mode"] == mode and shrunk == (mode == "truncate")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(path)
    with pytest.warns(UserWarning, match="checkpoint-corrupt"):
        blob = resume(out, tag, 1)
    assert blob["epoch"] == 3 and np.array_equal(blob["params"]["w"], np.full(64, 3, np.float32))
    assert load_checkpoint(generation_path(path, 1))["epoch"] == 3
    with pytest.raises(ValueError, match="Not valid corrupt mode"):
        corrupt_blob(path, "zero")


def test_corrupt_drill_falls_back_a_generation(tmp_path):
    """A death before the third checkpoint write of six rounds (two
    generations on disk), the newest corrupted: the resume falls back to
    the older one, loudly, and still lands on the uninterrupted run's
    params bit for bit."""
    plan = resolve_fault_plan({"kills": [{"point": "checkpoint", "at": 3}],
                               "corrupt": [{"which": "checkpoint", "mode": "flip",
                                            "generation": 0}]})
    with pytest.warns(UserWarning, match="checkpoint-corrupt"):
        rep = run_kill_drill(plan, {"num_epochs": {"global": 6, "local": 1}}, str(tmp_path),
                             device="cpu")
    assert rep["ok"] and rep["bitwise_equal"], rep
    assert len(rep["corruptions"]) == 1 and rep["kills_fired"] == [("checkpoint", 3)]


KILL_MATRIX = [(strategy, store, point) for strategy in ("masked", "grouped")
               for store in ("eager", "stream")
               for point in ("superstep", "fetch", "checkpoint", "prefetch")
               if point != "prefetch" or store == "stream"]


@pytest.mark.parametrize("strategy,store,point", KILL_MATRIX)
def test_kill_matrix_resume_bitwise(tmp_path, strategy, store, point):
    """A death at the point's first occurrence, a fresh experiment resumed
    from disk: the final params equal the uninterrupted run's bit for bit."""
    plan = resolve_fault_plan({"kills": [{"point": point, "at": 1}]})
    rep = run_kill_drill(plan, {"strategy": strategy, "client_store": store}, str(tmp_path),
                         device="cpu")
    assert rep["ok"] and rep["bitwise_equal"], rep
    assert rep["kills_fired"] == [(point, 1)] and rep["resumes"] == 1


def test_kill_plan_with_several_kills(tmp_path):
    """One logical run killed three times, the injector's counters running
    on across the resumes."""
    plan = resolve_fault_plan({"kills": [{"point": "superstep", "at": 2},
                                         {"point": "fetch", "at": 2},
                                         {"point": "checkpoint", "at": 2}]})
    rep = run_kill_drill(plan, {}, str(tmp_path), device="cpu")
    assert rep["ok"] and rep["resumes"] == 3, rep
    assert rep["kills_fired"] == [("superstep", 2), ("fetch", 2), ("checkpoint", 2)]


def test_pick_poison_uid_dodges_the_salted_retries():
    """The picked uid is in round 3's cohort and not in the cohort the first
    salted retry of round 3 draws (the replay that completes the run); a
    uid that no retry's cohort holds (``salt_seed`` compounding) is
    preferred when there is one."""
    cfg = drill_cfg("/nonexistent", device="cpu")
    uid = pick_poison_uid(cfg, 0, 3)

    def cohort(root):
        return set(round_users(round_seed(root, 3), 8, 4, "prp").tolist())

    root, retries = 0, []
    for n in (1, 2, 3):
        root = salt_seed(root, RETRY_SALT + n)
        retries.append(cohort(root))
    assert uid in cohort(0) and uid not in retries[0]
    dodge_all = [u for u in sorted(cohort(0)) if all(u not in r for r in retries)]
    assert uid == (dodge_all[0] if dodge_all else uid)
    with pytest.raises(ValueError, match="'prp' sampler"):
        pick_poison_uid(dict(cfg, sampler="perm"), 0, 3)


@pytest.mark.parametrize("strategy", ["masked", "grouped"])
@pytest.mark.parametrize("mode", ["quarantine", "rollback"])
def test_poison_drill(tmp_path, strategy, mode):
    rep = run_poison_drill(mode, {"strategy": strategy}, str(tmp_path), device="cpu")
    assert rep["ok"] and rep["final_params_finite"], rep
    if mode == "rollback":
        assert rep["trips"] == 1 and rep["recoveries"] == 1 and rep["poison_dodged"]
    else:
        assert rep["quarantined_total"] >= 1


def test_drill_cli_exits_zero_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-m", "heterofl_tpu_torch.chaos.drill", "--device",
                          "cpu", "--json", "--out", str(tmp_path)], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["drills"][0]["bitwise_equal"]


def test_drill_cli_refuses_cuda_without_a_gpu(tmp_path):
    import torch

    from heterofl_tpu_torch.chaos import drill

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        drill.main(["--json", "--out", str(tmp_path)])
