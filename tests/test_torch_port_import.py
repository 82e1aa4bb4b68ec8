"""Import hygiene of the PyTorch/CUDA port: it never loads JAX or the
reference package, so it runs on a GPU host that has neither."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "heterofl_tpu_torch")


def _port_files():
    """Every port module, ``chip_smoke.py``, the port's scripts
    (``scripts/torch_port_*.py``, ``scripts/bn_plan_sweep.py`` and
    ``scripts/sgd_plan_sweep.py``) and the two-rank tests' rank jobs
    (``tests/torch_port_ranks.py``)."""
    scripts = os.path.join(ROOT, "scripts")
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(scripts, "bn_plan_sweep.py"),
           os.path.join(scripts, "sgd_plan_sweep.py"),
           os.path.join(ROOT, "tests", "torch_port_ranks.py")]
    out += glob.glob(os.path.join(scripts, "torch_port_*.py"))
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "heterofl_tpu"


def _port_modules():
    mods = []
    for f in _port_files():
        rel = os.path.relpath(f, ROOT)
        if rel.startswith("heterofl_tpu_torch"):
            mods.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    return mods


#: the ``python -m`` tools run to their end, in order, in ONE fresh
#: interpreter: (name, module, argv (None: import it only), working
#: directory under the run's root); ``{out}`` is the root.  The audit runs
#: before the drill, whose runs switch deterministic algorithms on and off
TOOLS = [
    ("multi", "heterofl_tpu_torch.multi", None, ""),
    ("lint", "heterofl_tpu_torch.staticcheck", ["--lint-only"], "tools"),
    ("audit", "heterofl_tpu_torch.staticcheck",
     ["--device", "cpu", "--diff-baseline"], "tools"),
    ("summary", "heterofl_tpu_torch.analysis.summary",
     ["--device", "cpu", "--control_name", "1_10_0.5_iid_fix_a1-e1_bn_1_1", "--data_name",
      "MNIST", "--model_name", "conv", "--synthetic", "1", "--synthetic_sizes",
      '{"train": 40, "test": 20}', "--output_dir", "{out}/tools/out", "--override",
      '{"conv": {"hidden_size": [4, 8]}}'], "tools"),
    ("process", "heterofl_tpu_torch.analysis.process",
     ["--output_dir", "{out}/tools/out", "--xlsx", "0", "--figures", "0"], "tools"),
    ("make", "heterofl_tpu_torch.analysis.make", ["--model", "conv", "--gpus", "0,1"], "tools"),
    ("sweep", "heterofl_tpu_torch.multi.sweep",
     ["--device", "cpu", "--dry_run", "1", "--grid", '{"seed": [0, 1], "wire_codec": ["dense"]}'],
     ""),
    ("drill", "heterofl_tpu_torch.chaos.drill",
     ["--device", "cpu", "--json", "--out", "{out}/drill"], ""),
    ("pod", "heterofl_tpu_torch.parallel.pod", ["{out}/pod", "--spawn", "2"], "tools"),
    ("ring_attention", "heterofl_tpu_torch.parallel.ring_attention", None, ""),
    ("long_context", "heterofl_tpu_torch.parallel.long_context", None, ""),
    ("data_rank", "chip_smoke", None, ""),
]


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    """Every port module imported, then each of :data:`TOOLS` run to its end
    (``runpy``, ``SystemExit`` 0), in one fresh interpreter, the modules of
    ``jax``, ``jaxlib`` and ``heterofl_tpu`` in its ``sys.modules`` read
    after each -> ``(root, {name: {"ok", "error", "bad"}})``, ``"import"``
    the first."""
    root = tmp_path_factory.mktemp("tools")
    for sub in ("tools",):
        (root / sub).mkdir()
    code = f"""
import importlib, json, os, runpy, sys, traceback
def bad():
    return sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'heterofl_tpu'))
out = {{}}
try:
    for m in {_port_modules()!r}:
        importlib.import_module(m)
    out['import'] = {{'ok': True, 'error': '', 'bad': bad()}}
except BaseException:
    out['import'] = {{'ok': False, 'error': traceback.format_exc()[-2000:], 'bad': bad()}}
for name, mod, argv, cwd in {TOOLS!r}:
    os.chdir(os.path.join({str(root)!r}, cwd))
    ok, err = True, ''
    try:
        if argv is None:
            importlib.import_module(mod)
        else:
            sys.argv = [mod] + [a.replace('{{out}}', {str(root)!r}) for a in argv]
            runpy.run_module(mod, run_name='__main__')
    except SystemExit as e:
        ok, err = not e.code, 'exit %r' % (e.code,)
    except BaseException:
        ok, err = False, traceback.format_exc()[-2000:]
    out[name] = {{'ok': ok, 'error': err, 'bad': bad()}}
print('RESULT ' + json.dumps(out))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "2"  # as the test files' own torch threads
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return root, json.loads(line[len("RESULT "):])


def _assert_clean(runs, names):
    for name in names:
        assert runs[name]["ok"], (name, runs[name]["error"])
        assert runs[name]["bad"] == [], (name, runs[name]["bad"][:5])


def test_import_loads_no_jax_and_no_reference(tool_runs):
    """A fresh interpreter imports every port module; neither ``jax`` nor any
    ``heterofl_tpu`` (reference) module ends up in ``sys.modules``."""
    _, runs = tool_runs
    _assert_clean(runs, ["import"])
    assert len(_port_modules()) >= 20


def test_no_port_file_imports_jax_or_reference():
    """AST scan of every port file, chip_smoke.py and the port's scripts:
    no ``import jax`` / ``from heterofl_tpu...`` anywhere, not even
    inside a function."""
    offenders = []
    for f in _port_files():
        with open(f) as fh:
            tree = ast.parse(fh.read(), f)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [(os.path.relpath(f, ROOT), n) for n in names if _forbidden(n)]
    assert offenders == []
    scanned = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert {"scripts/bn_plan_sweep.py", "scripts/sgd_plan_sweep.py",
            "scripts/torch_port_profile.py",
            "scripts/torch_port_round_time.py", "heterofl_tpu_torch/data/stats.py",
            "heterofl_tpu_torch/data/datasets.py", "heterofl_tpu_torch/fed/core.py",
            "heterofl_tpu_torch/models/resnet.py", "heterofl_tpu_torch/models/norms.py",
            "heterofl_tpu_torch/parallel/grouped.py", "heterofl_tpu_torch/fed/sliced.py",
            "heterofl_tpu_torch/fed/sampling.py", "heterofl_tpu_torch/parallel/staging.py",
            "heterofl_tpu_torch/parallel/step_graph.py", "heterofl_tpu_torch/sched/__init__.py",
            "heterofl_tpu_torch/sched/deadline.py", "heterofl_tpu_torch/sched/buffer.py",
            "heterofl_tpu_torch/obs/__init__.py", "heterofl_tpu_torch/obs/probes.py",
            "heterofl_tpu_torch/obs/hist.py", "heterofl_tpu_torch/obs/watchdog.py",
            "heterofl_tpu_torch/obs/trace.py", "heterofl_tpu_torch/obs/ledger.py",
            "heterofl_tpu_torch/obs/report.py", "heterofl_tpu_torch/chaos/__init__.py",
            "heterofl_tpu_torch/chaos/inject.py", "heterofl_tpu_torch/chaos/drill.py",
            "heterofl_tpu_torch/multi/__init__.py", "heterofl_tpu_torch/multi/sweep.py",
            "heterofl_tpu_torch/analysis/__init__.py", "heterofl_tpu_torch/analysis/summary.py",
            "heterofl_tpu_torch/analysis/process.py", "heterofl_tpu_torch/analysis/make.py",
            "heterofl_tpu_torch/staticcheck/__init__.py",
            "heterofl_tpu_torch/staticcheck/__main__.py",
            "heterofl_tpu_torch/staticcheck/report.py", "heterofl_tpu_torch/staticcheck/rules.py",
            "heterofl_tpu_torch/staticcheck/wire.py", "heterofl_tpu_torch/staticcheck/memory.py",
            "heterofl_tpu_torch/staticcheck/kernels.py",
            "heterofl_tpu_torch/staticcheck/audit.py",
            "heterofl_tpu_torch/staticcheck/ratchet.py", "tests/torch_port_ranks.py",
            "heterofl_tpu_torch/parallel/ring_attention.py",
            "heterofl_tpu_torch/parallel/long_context.py"} <= scanned


def test_python_m_tools_load_no_jax_and_no_reference(tool_runs):
    """The ``python -m`` tools of the chaos harness and the arms, run to
    their end in a fresh interpreter (the drill's CPU run, the sweep's dry
    run), leave no ``jax`` and no ``heterofl_tpu`` module in
    ``sys.modules``; ``multi/`` alone neither."""
    _, runs = tool_runs
    _assert_clean(runs, ["multi", "drill", "sweep"])


def test_analysis_and_staticcheck_tools_load_no_jax_and_no_reference(tool_runs):
    """The ``python -m`` tools of the analysis and the audit, run to their
    end in a fresh interpreter in an empty directory (the profiler on the
    CPU, the aggregation of an empty output, the grid generator, the lint,
    and the whole CPU audit against the committed baseline), leave no
    ``jax`` and no ``heterofl_tpu`` module in ``sys.modules``."""
    root, runs = tool_runs
    _assert_clean(runs, ["summary", "process", "make", "lint", "audit"])
    assert (root / "tools" / "out" / "result" / "MNIST_conv_a.pkl").exists()
    assert (root / "tools" / "out" / "result.csv").exists()
    assert (root / "tools" / "train_conv_iid.sh").exists()


def test_mesh_and_pod_probe_load_no_jax_and_no_reference(tool_runs):
    """The clients mesh axis: ``parallel/mesh.py`` and ``parallel/pod.py`` are
    scanned, and ``python -m heterofl_tpu_torch.parallel.pod --spawn 2`` runs
    to its end in a fresh interpreter (the grouped slices probe at two gloo
    ranks and the one-rank run, compared; exit 0) with no ``jax`` and no
    ``heterofl_tpu`` module in the parent's ``sys.modules`` nor in any
    rank's (each rank records its own); the ranks ran the grouped engine
    under ``slices``, a level a rank."""
    scanned = {os.path.relpath(f, ROOT).replace(os.sep, "/") for f in _port_files()}
    assert {"heterofl_tpu_torch/parallel/mesh.py", "heterofl_tpu_torch/parallel/pod.py"} \
        <= scanned
    root, runs = tool_runs
    _assert_clean(runs, ["pod"])
    out = str(root / "pod")
    for sub, n in (("ranks2", 2), ("ranks1", 1)):
        for r in range(n):
            with open(os.path.join(out, sub, f"pod_result_p{r}.json")) as f:
                res = json.load(f)
            assert res["foreign_modules"] == []
            assert (res["engine"], res["placement"]) == \
                ("grouped", "slices" if n == 2 else "span")


def test_data_axis_modules_load_no_jax_and_no_reference(tool_runs):
    """The data axis's modules -- ring attention, ``SeqParallelLM`` -- and
    ``chip_smoke.py``, whose ``--data-rank`` entry is phase 17's rank
    (``data_rank_main``, beside ``data_lm_runs``; the grouped runs and the
    batched synchronised pair's phase too), imported in a fresh
    interpreter, leave no ``jax`` and no ``heterofl_tpu`` module in
    ``sys.modules``."""
    _, runs = tool_runs
    _assert_clean(runs, ["ring_attention", "long_context", "data_rank"])
    import chip_smoke

    assert callable(chip_smoke.data_rank_main) and callable(chip_smoke.data_lm_runs)
    assert callable(chip_smoke.sync_bn_batched_phase) and chip_smoke.DATA_GROUPED_RUNS
