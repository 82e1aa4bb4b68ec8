"""The port's lint and runtime audit (``heterofl_tpu_torch.staticcheck``) on
the CPU.

Contracts:

* the port's tree lints clean: every legitimate use of a banned call
  carries its pragma, and every pragma suppresses something;
* each rule trips on a seeded snippet in its scope, is silenced by its
  pragma, and a pragma that silences nothing is a ``stale-pragma``;
* the CPU audit at test widths has zero findings, and its metrics equal
  the committed ``baseline.json``'s ``cpu`` section;
* a seeded extra launch in a step, a seeded payload byte, a seeded
  recapture (a step key that changes with a fresh but identical host
  input) and a seeded float64 buffer each trip their named finding;
* the ratchet: a fresh audit against the committed section is clean; a
  seeded regression in a baseline exits 2; a lowered launch budget is an
  audit finding and exits 1; ``--update-baseline`` re-pins a section;
  ``--device cuda`` without a device raises; the report goes only where
  ``--out`` says.
"""

import json

import pytest
import torch

from heterofl_tpu_torch.staticcheck import __main__ as cli
from heterofl_tpu_torch.staticcheck import rules
from heterofl_tpu_torch.staticcheck.audit import run_audit
from heterofl_tpu_torch.staticcheck.ratchet import (BASELINE_PATH, baseline_view, diff_reports,
                                                    load_baseline)
from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

ENGINE = "heterofl_tpu_torch/parallel/round_engine.py"
DRIVER = "heterofl_tpu_torch/entry/common.py"
OPS = "heterofl_tpu_torch/ops/layers.py"

#: (rule, path, a snippet that trips it)
SEEDS = [
    ("no-block-until-ready", ENGINE, "import torch\ntorch.cuda.synchronize()\n"),
    ("no-block-until-ready", ENGINE, "def f(ev):\n    ev.synchronize()\n"),
    ("no-device-get", ENGINE, "def f(x):\n    return x.item()\n"),
    ("no-device-get", ENGINE, "def f(x):\n    return x.cpu()\n"),
    ("no-float-coercion", ENGINE, "import torch\ndef f(x):\n    return float(x.sum())\n"),
    ("no-float-coercion", ENGINE, "import torch\ndef f(x):\n    return bool(torch.any(x))\n"),
    ("no-wallclock", "heterofl_tpu_torch/fed/core.py", "import time\nt = time.time()\n"),
    ("no-fresh-rng", ENGINE, "import numpy as np\nr = np.random.default_rng(0)\n"),
    ("no-fresh-rng", ENGINE, "import torch\ng = torch.Generator()\n"),
    ("no-fresh-rng", ENGINE, "import torch\ntorch.manual_seed(1)\n"),
    ("no-shadowed-inline-import", DRIVER, "import math\ndef f():\n    import math\n"),
    ("no-host-eval-in-driver", DRIVER, "def f(ev, p):\n    return ev.eval_users(p)\n"),
    ("no-library-kernel", OPS,
     "import torch.nn.functional as F\ndef f(x):\n    return F.batch_norm(x, None, None)\n"),
    ("no-library-kernel", OPS, "import torch\ndef f(ps, gs):\n    torch._foreach_add_(ps, gs)\n"),
    ("no-library-kernel", ENGINE, "import torch\nopt = torch.optim.SGD([], lr=0.1)\n"),
    ("no-library-kernel", ENGINE, "import torch\nf = torch.compile(lambda x: x)\n"),
]


def test_port_tree_lints_clean():
    findings = rules.lint_package()
    assert findings == [], "\n".join(map(str, findings))


@pytest.mark.parametrize("rule,path,src", SEEDS,
                         ids=[f"{r}-{i}" for i, (r, _p, _s) in enumerate(SEEDS)])
def test_rule_trips_and_pragma_silences(rule, path, src):
    found = rules.lint_source(src, path)
    assert [f.rule for f in found] == [rule], found
    lines = src.rstrip("\n").split("\n")
    line = found[0].where.rsplit(":", 1)[1]
    i = int(line) - 1
    lines[i] = f"{lines[i]}  # staticcheck: allow({rule}) the seeded reason"
    assert rules.lint_source("\n".join(lines) + "\n", path) == []
    # out of its scope the snippet is clean, and a pragma there is stale
    other = "heterofl_tpu_torch/analysis/process.py"
    assert rules.lint_source(src, other) == []
    stale = rules.lint_source("\n".join(lines) + "\n", other)
    assert [f.rule for f in stale] == ["stale-pragma"]


def test_seeded_generator_and_host_values_pass():
    src = ("import torch\nimport numpy as np\n"
           "g = torch.Generator().manual_seed(3)\n"
           "n = int(np.sum([1, 2]))\n"
           "f = float(3)\n")
    assert rules.lint_source(src, ENGINE) == []
    dead = "x = 1  # staticcheck: allow(no-device-get) nothing here\n"
    assert [f.rule for f in rules.lint_source(dead, ENGINE)] == ["stale-pragma"]
    unknown = "x = 1  # staticcheck: allow(no-such-rule) typo\n"
    assert "unknown rule" in rules.lint_source(unknown, ENGINE)[0].message
    text = 's = "# staticcheck: allow(no-device-get)"\n'  # not a comment
    assert rules.lint_source(text, ENGINE) == []


@pytest.fixture(scope="module")
def cpu_report():
    return run_audit("cpu", budget=load_baseline(BASELINE_PATH, "cpu"))


def test_cpu_audit_is_green_and_equals_the_baseline(cpu_report):
    assert cpu_report.ok, [str(f) for f in cpu_report.all_findings()]
    assert cpu_report.all_findings() == []
    section = load_baseline(BASELINE_PATH, "cpu")
    view = baseline_view(cpu_report.to_dict())
    assert view["config"] == section["config"]
    assert view["programs"] == section["programs"]
    assert view["flops"] == section["flops"]
    diff = diff_reports(cpu_report.to_dict(), section)
    assert diff["ok"] and diff["regressions"] == [] and diff["improvements"] == []
    progs = cpu_report.programs
    assert len(progs) == 10
    # one host_fetch a superstep; the telemetry twins launch their plain steps'
    for name, p in progs.items():
        assert p.host_fetches == (1 if "/k2" in name else None), name
    assert progs["masked/k2-hist"].launches == progs["masked/k2"].launches != {}
    # the int8 payload is the codec's lanes; grouped dense moves the merged
    # global sums and counts in its one all-reduce, the map every level's
    assert progs["masked/k2-int8"].wire["level_bytes"] * 3.9 < \
        progs["masked/k2"].wire["level_bytes"]
    assert len(progs["grouped/k2"].wire["levels"]) == 1
    assert progs["grouped/k2"].wire["level_bytes"] == progs["masked/k2"].wire["level_bytes"]
    assert len(progs["grouped/k2-map"].wire["levels"]) == 5
    assert cpu_report.flop_budget["ok"] and cpu_report.wire_frontier["ok"]


def _audit_one(name, tamper):
    return run_audit("cpu", budget=load_baseline(BASELINE_PATH, "cpu"), only=name,
                     tamper=tamper).programs[name]


def test_seeded_extra_launch_trips_the_budget():
    def tamper(name, exp):
        body = exp.engine._counted_vision_step

        def with_extra(st, *a):
            body(st, *a)
            st["acc"].add_(0.0)  # one more op a step

        exp.engine._counted_vision_step = with_extra

    rep = _audit_one("masked/k2", tamper)
    assert [f.rule for f in rep.findings] == ["launch-budget"] * len(rep.launches)


def test_seeded_payload_byte_trips_the_wire_budget():
    def tamper(name, exp):
        codec = exp.engine.codec
        encode = codec.encode

        def smuggle(*a, **kw):
            payload, resid = encode(*a, **kw)
            return dict(payload, x=torch.zeros(1, dtype=torch.uint8)), resid

        codec.encode = smuggle

    rep = _audit_one("masked/k2-int8", tamper)
    assert {f.rule for f in rep.findings} == {"wire-budget"}
    assert "[2937] bytes" in rep.findings[0].message  # the int8 lanes' 2936 and the byte


def test_seeded_recapture_trips_the_hazard():
    def tamper(name, exp):
        get = exp.engine.graphs.get
        superstep = exp.engine.train_superstep
        fresh = {"n": 0}

        def leaky_superstep(*a, **kw):
            fresh["n"] += 1  # a key that changes with each fresh but identical input
            return superstep(*a, **kw)

        def leaky_get(key, fn, reset, generators=()):
            return get(key + (fresh["n"],), fn, reset, generators)

        exp.engine.train_superstep = leaky_superstep
        exp.engine.graphs.get = leaky_get

    rep = _audit_one("grouped/k2", tamper)
    assert "recompile-hazard" in {f.rule for f in rep.findings}
    assert rep.recompile["after_second"] > rep.recompile["after_first"]


def test_seeded_float64_buffer_trips():
    def tamper(name, exp):
        slots = exp.engine._slots

        def f64_slots(P, data):
            st = slots(P, data)
            st["stray"] = torch.zeros(2, dtype=torch.float64)
            return st

        exp.engine._slots = f64_slots

    rep = _audit_one("masked/k2", tamper)
    assert [f.rule for f in rep.findings] == ["float64"]


def test_wire_records_equal_reference():
    """The analytic wire records and the headline's codec frontier equal the
    JAX package's (``staticcheck/wire.py``, ``audit.codec_frontier_check``)."""
    from heterofl_tpu.staticcheck import audit as r_audit
    from heterofl_tpu.staticcheck import report as r_report
    from heterofl_tpu.staticcheck import wire as r_wire
    from heterofl_tpu_torch.staticcheck import audit, wire
    from heterofl_tpu_torch.staticcheck.report import AuditReport

    for p in (1, 2, 8):
        assert wire.dense_round_wire(1000, p) == r_wire.dense_round_wire(1000, p)
        assert wire.dense_round_wire(1000, p, 12) == r_wire.dense_round_wire(1000, p, 12)
        assert wire.codec_round_wire("int8", 250, 1000, p) == \
            r_wire.codec_round_wire("int8", 250, 1000, p)
    head = audit.with_data_fields(audit.default_audit_cfg(True))
    sec = audit.codec_frontier_check(AuditReport(), head)
    ref = r_audit.codec_frontier_check(r_report.AuditReport())
    assert sec["ok"] and ref["ok"]
    assert sec["dense_bytes"] == ref["flagship_dense_bytes"] == 89_377_360
    assert sec["codecs"] == ref["codecs"]


def test_cli_codes_and_ratchet(tmp_path, monkeypatch, capsys, cpu_report):
    """The CLI's exit codes and files.  Its full audits are the module's
    (``cpu_report``: the audit is deterministic, and the CLI's own run of it
    is the import test's); the lowered budget's finding comes from a real
    audit of the program whose budget was lowered."""
    import copy

    from heterofl_tpu_torch.staticcheck import audit

    real = audit.run_audit

    def run_audit(device="cpu", flagship=False, budget=None, **kw):
        assert (device, flagship, kw) == ("cpu", False, {})
        steps = (((budget or {}).get("programs") or {}).get("masked/k2") or {}).get("launches")
        if steps and steps != cpu_report.programs["masked/k2"].launches:
            return real(device, flagship, budget=budget, only="masked/k2")
        return copy.deepcopy(cpu_report)

    monkeypatch.setattr(audit, "run_audit", run_audit)
    monkeypatch.chdir(tmp_path)
    pinned = tmp_path / "pinned.json"
    out = tmp_path / "report.json"
    assert cli.main(["--device", "cpu", "--update-baseline", "--baseline", str(pinned),
                     "--out", str(out)]) == 0
    section = load_baseline(str(pinned), "cpu")
    committed = load_baseline(BASELINE_PATH, "cpu")
    assert section["programs"] == committed["programs"]
    assert json.loads(out.read_text())["ok"] is True
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pinned.json", "report.json"]
    # a seeded regression: the baseline pins fewer wire bytes than the audit moves
    data = json.loads(pinned.read_text())
    data["cpu"]["programs"]["masked/k2"]["wire_bytes"] -= 1
    regressed = tmp_path / "regressed.json"
    regressed.write_text(json.dumps(data))
    assert cli.main(["--device", "cpu", "--diff-baseline", "--baseline", str(regressed)]) == 2
    assert "RATCHET REGRESSED" in capsys.readouterr().out
    # a lowered launch budget is the audit's own finding: exit 1
    data = json.loads(pinned.read_text())
    steps = data["cpu"]["programs"]["masked/k2"]["launches"]
    key = sorted(steps)[0]
    steps[key] -= 1
    lowered = tmp_path / "lowered.json"
    lowered.write_text(json.dumps(data))
    assert cli.main(["--device", "cpu", "--diff-baseline", "--baseline", str(lowered)]) == 1
    assert "[launch-budget]" in capsys.readouterr().out


def test_cli_lint_only_and_cuda_refusal(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--lint-only"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["--lint-only", "--diff-baseline"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--device", "cuda"])
    assert list(tmp_path.iterdir()) == []
