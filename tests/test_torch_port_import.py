"""Import hygiene of the PyTorch/CUDA port: it never loads JAX or the
reference package, so it runs on a GPU host that has neither."""

import ast
import glob
import os
import subprocess
import sys

from heterofl_tpu_torch.testing import thread_limit_fixture

few_threads = thread_limit_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "heterofl_tpu_torch")


def _port_files():
    """Every port module, ``chip_smoke.py`` and the port's scripts
    (``scripts/torch_port_*.py``, ``scripts/bn_plan_sweep.py`` and
    ``scripts/sgd_plan_sweep.py``)."""
    scripts = os.path.join(ROOT, "scripts")
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(scripts, "bn_plan_sweep.py"),
           os.path.join(scripts, "sgd_plan_sweep.py")]
    out += glob.glob(os.path.join(scripts, "torch_port_*.py"))
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "heterofl_tpu"


def test_import_loads_no_jax_and_no_reference():
    """A fresh interpreter imports every port module; neither ``jax`` nor any
    ``heterofl_tpu`` (reference) module ends up in ``sys.modules``."""
    mods = []
    for f in _port_files():
        rel = os.path.relpath(f, ROOT)
        if rel.startswith("heterofl_tpu_torch"):
            mods.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'heterofl_tpu'))\n"
            "print(len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "0", out.stdout
    assert len(mods) >= 20


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
            "heterofl_tpu_torch/staticcheck/ratchet.py"} <= scanned


def test_python_m_tools_load_no_jax_and_no_reference(tmp_path):
    """The ``python -m`` tools of the chaos harness and the arms, run to
    their end in a fresh interpreter (the drill's CPU run, the sweep's dry
    run), leave no ``jax`` and no ``heterofl_tpu`` module in
    ``sys.modules``; ``multi/`` alone neither."""
    runs = [("heterofl_tpu_torch.chaos.drill", ["--device", "cpu", "--json", "--out",
                                                 str(tmp_path / "drill")]),
            ("heterofl_tpu_torch.multi.sweep", ["--device", "cpu", "--dry_run", "1", "--grid",
                                                '{"seed": [0, 1], "wire_codec": ["dense"]}']),
            ("heterofl_tpu_torch.multi", None)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    for mod, argv in runs:
        run = f"importlib.import_module({mod!r})" if argv is None else (
            f"sys.argv = [{mod!r}] + {argv!r}\n"
            "try:\n"
            f"    runpy.run_module({mod!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code")
        code = ("import importlib, runpy, sys\n" + run + "\n"
                "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'heterofl_tpu'))\n"
                "print('BAD', len(bad), bad[:5])\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=ROOT, env=env, timeout=300)
        assert out.returncode == 0, (mod, out.stderr[-2000:])
        assert "BAD 0 []" in out.stdout, (mod, out.stdout[-500:])


def test_analysis_and_staticcheck_tools_load_no_jax_and_no_reference(tmp_path):
    """The ``python -m`` tools of the analysis and the audit, run to their
    end in a fresh interpreter in an empty directory (the profiler on the
    CPU, the aggregation of an empty output, the grid generator, the lint,
    and the CPU audit against the committed baseline), leave no ``jax``
    and no ``heterofl_tpu`` module in ``sys.modules``."""
    out = str(tmp_path / "out")
    runs = [("heterofl_tpu_torch.analysis.summary",
             ["--device", "cpu", "--control_name", "1_10_0.5_iid_fix_a1-e1_bn_1_1",
              "--data_name", "MNIST", "--model_name", "conv", "--synthetic", "1",
              "--synthetic_sizes", '{"train": 40, "test": 20}', "--output_dir", out,
              "--override", '{"conv": {"hidden_size": [4, 8]}}']),
            ("heterofl_tpu_torch.analysis.process",
             ["--output_dir", out, "--xlsx", "0", "--figures", "0"]),
            ("heterofl_tpu_torch.analysis.make", ["--model", "conv", "--gpus", "0,1"]),
            ("heterofl_tpu_torch.staticcheck", ["--lint-only"]),
            ("heterofl_tpu_torch.staticcheck", ["--device", "cpu", "--diff-baseline"])]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    for mod, argv in runs:
        code = ("import runpy, sys\n"
                f"sys.argv = [{mod!r}] + {argv!r}\n"
                "try:\n"
                f"    runpy.run_module({mod!r}, run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    assert not e.code, e.code\n"
                "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'heterofl_tpu'))\n"
                "print('BAD', len(bad), bad[:5])\n")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=tmp_path, env=env, timeout=300)
        assert res.returncode == 0, (mod, argv, res.stderr[-2000:])
        assert "BAD 0 []" in res.stdout, (mod, res.stdout[-500:])
    assert (tmp_path / "out" / "result" / "MNIST_conv_a.pkl").exists()
    assert (tmp_path / "out" / "result.csv").exists()
    assert (tmp_path / "train_conv_iid.sh").exists()


def test_mesh_and_pod_probe_load_no_jax_and_no_reference(tmp_path):
    """The clients mesh axis: ``parallel/mesh.py`` and ``parallel/pod.py`` are
    scanned, and ``python -m heterofl_tpu_torch.parallel.pod --spawn 2`` runs
    to its end in a fresh interpreter (two gloo ranks and the one-rank run,
    compared; exit 0) with no ``jax`` and no ``heterofl_tpu`` module in the
    parent's ``sys.modules`` nor in any rank's (each rank records its own)."""
    import json

    scanned = {os.path.relpath(f, ROOT).replace(os.sep, "/") for f in _port_files()}
    assert {"heterofl_tpu_torch/parallel/mesh.py", "heterofl_tpu_torch/parallel/pod.py"} \
        <= scanned
    mod, out = "heterofl_tpu_torch.parallel.pod", str(tmp_path / "pod")
    code = ("import runpy, sys\n"
            f"sys.argv = [{mod!r}, {out!r}, '--spawn', '2']\n"
            "try:\n"
            f"    runpy.run_module({mod!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'heterofl_tpu'))\n"
            "print('BAD', len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "BAD 0 []" in res.stdout, res.stdout[-500:]
    for sub, n in (("ranks2", 2), ("ranks1", 1)):
        for r in range(n):
            with open(os.path.join(out, sub, f"pod_result_p{r}.json")) as f:
                assert json.load(f)["foreign_modules"] == []
