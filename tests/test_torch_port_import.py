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
            "heterofl_tpu_torch/chaos/inject.py"} <= scanned
