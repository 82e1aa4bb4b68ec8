"""The scheduler keys ``patience``, ``threshold`` and ``min_lr`` and the
reference's inert keys in the port's default cfg and CLI.

Contracts:

* ``make_scheduler(process_control(default cfg + override))`` equals the
  reference's for every scheduler kind at rounds 1, 200 and 400 without
  either side being handed the three keys: Cosine at round 400 is the
  reference's 1.015e-4 (not the 0.0 floor's 1.5e-6), and Plateau fed 400
  flat evaluations floors at ``min_lr`` 1e-4;
* the CLI parses ``--min_lr``, ``--patience`` and ``--threshold``;
* the reference's inert keys (``shuffle``, ``num_workers``,
  ``metric_name``, ``log_interval``, ``save_format``, ``param_dtype``) are
  accepted, as documented no-ops, with the reference's defaults, by the
  cfg and the CLI.
"""

import math

import pytest

from heterofl_tpu import config as RC
from heterofl_tpu.utils.optim import make_scheduler as r_make_scheduler
from heterofl_tpu_torch import config as PC
from heterofl_tpu_torch.entry.common import build_cli, cfg_from_args
from heterofl_tpu_torch.testing import thread_limit_fixture
from heterofl_tpu_torch.utils import make_scheduler

few_threads = thread_limit_fixture()

HEADLINE = "1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
KINDS = ["None", "StepLR", "MultiStepLR", "ExponentialLR", "CosineAnnealingLR", "CyclicLR",
         "ReduceLROnPlateau"]
INERT = ("shuffle", "num_workers", "metric_name", "log_interval", "save_format",
         "param_dtype")


def _cfg(mod, name):
    cfg = mod.default_cfg()
    cfg["control"] = mod.parse_control_name(HEADLINE)
    cfg["override"] = {"scheduler_name": name}
    return mod.process_control(cfg)


@pytest.mark.parametrize("name", KINDS)
def test_scheduler_of_the_default_cfg_equals_reference(name):
    """Neither side is handed the three keys: each reads its own defaults."""
    pcfg, rcfg = _cfg(PC, name), _cfg(RC, name)
    for key in ("patience", "threshold", "min_lr"):
        assert pcfg[key] == rcfg[key] == RC.DEFAULT_CFG[key]
    port, ref = make_scheduler(pcfg), r_make_scheduler(rcfg)
    if name == "ReduceLROnPlateau":
        got, want = [], []
        for e in range(1, 401):
            got.append(port(e))
            want.append(ref(e))
            port.step_metric(1.0)  # flat evaluations
            ref.step_metric(1.0)
        assert got == want
        assert port(401) == ref(401) == pytest.approx(1e-4)
        return
    assert [port(e) for e in (1, 200, 400)] == [ref(e) for e in (1, 200, 400)]
    if name == "CosineAnnealingLR":
        assert port(400) == pytest.approx(1.015e-4, rel=1e-3)


def test_scheduler_without_the_keys_raises():
    """The fallbacks are gone: a cfg without ``min_lr`` raises."""
    with pytest.raises(KeyError, match="min_lr"):
        make_scheduler({"scheduler_name": "CosineAnnealingLR", "lr": 0.1,
                        "num_epochs": {"global": 10}})
    with pytest.raises(KeyError, match="patience"):
        make_scheduler({"scheduler_name": "ReduceLROnPlateau", "lr": 0.1, "factor": 0.5})


def test_cli_parses_the_scheduler_keys():
    args = build_cli("t").parse_args(["--min_lr", "0.002", "--patience", "4",
                                      "--threshold", "0.01"])
    cfg = cfg_from_args(args)
    assert (cfg["min_lr"], cfg["patience"], cfg["threshold"]) == (0.002, 4, 0.01)
    assert isinstance(cfg["patience"], int)
    default = cfg_from_args(build_cli("t").parse_args([]))
    assert default["min_lr"] == 1e-4 and default["patience"] == 10
    cfg = dict(default, scheduler_name="CosineAnnealingLR", lr=0.1,
               num_epochs={"global": 400})
    assert make_scheduler(dict(cfg, min_lr=0.002))(400) > make_scheduler(cfg)(400)
    assert not math.isclose(make_scheduler(dict(cfg, min_lr=0.002))(400),
                            make_scheduler(cfg)(400))


@pytest.mark.parametrize("key", INERT)
def test_inert_keys_are_accepted(key):
    """Each inert key has the reference's default, survives
    ``process_control`` and is taken by the CLI (a dict as JSON)."""
    assert PC.DEFAULT_CFG[key] == RC.DEFAULT_CFG[key]
    assert key not in PC.UNPORTED
    value = {"shuffle": '{"train": false, "test": false}', "num_workers": "2",
             "metric_name": '{"train": ["Loss"], "test": ["Loss"]}', "log_interval": "0.5",
             "save_format": "png", "param_dtype": "float32"}[key]
    cfg = cfg_from_args(build_cli("t").parse_args([f"--{key}", value,
                                                   "--control_name", HEADLINE]))
    assert cfg[key] != PC.DEFAULT_CFG[key] or key == "param_dtype"
    out = PC.process_control(cfg)
    assert out[key] == cfg[key]
