"""Work a rank for the two-rank tests: :func:`run_ranks` runs a job (a
masked round with its draws handed in, an evaluation, an entry) as
``n`` gloo ranks on the CPU, one process a rank started as torchrun
would start it (``heterofl_tpu_torch.parallel.pod._spawn``: torchrun's
variables, a free port each run, a timeout of its own), and returns each
rank's pickled result.  Run as a script, this module is one such rank:
``python tests/torch_port_ranks.py JOB.pkl``."""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Dict, List

import numpy as np


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_ranks(job: Dict[str, Any], n_processes: int, out_dir: str,
              timeout_s: int = 300) -> List[Any]:
    """Run ``job`` (:func:`job_main`) as ``n_processes`` ranks -> each
    rank's pickled result, by rank (its standard output in
    ``rank<r>.out``)."""
    from heterofl_tpu_torch.parallel.pod import _spawn

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(job, out_dir=out_dir), f)
    stdouts = _spawn([sys.executable, os.path.abspath(__file__), path], n_processes,
                     timeout_s)
    out = []
    for i in range(n_processes):
        with open(os.path.join(out_dir, f"rank{i}.out"), "w") as f:
            f.write(stdouts[i])
        with open(os.path.join(out_dir, f"rank{i}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _round_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """One masked round of ``job['cfg']`` on the cohort ``users`` from
    reference-layout ``params`` on ``data`` (under ``sharded`` placement,
    this rank's block of it), with the draws handed in: ``epoch_perms``
    ``{uid: [E, N]}``, ``codec_noise`` one a rank (flat port layout),
    ``lm_draws`` ``{(uid, t): draws}`` -> the new params (reference layout
    and flat), the metric sums and the residual row."""
    from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel.round_engine import RoundEngine, shard_client_data

    cfg = job["cfg"]
    model = make_model(cfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(job["params"], perms))
    model = model.to(mesh.device)
    eng = RoundEngine(model, cfg, mesh.device, mesh)
    data = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in job["data"])
    if eng.placement == "sharded":
        data = shard_client_data(data, mesh.size, mesh.rank)
    data = tuple(a.to(mesh.device) for a in data)
    noise, draws = job.get("codec_noise"), job.get("lm_draws")
    P, ms = eng.train_round(
        eng.flatten(model.params()), job["lr"], job["users"], data, round_seed=0,
        epoch_perms=job.get("epoch_perms"),
        codec_noise=None if noise is None else torch.from_numpy(noise[mesh.rank]).to(mesh.device),
        lm_draws=None if draws is None else (lambda u, t: draws[u, t]))
    return {"round": {k: (_host(v) if torch.is_tensor(v) else v) for k, v in ms.items()},
            "params": params_to_jax(eng.unflatten(P), perms), "flat": _host(P),
            "resid": eng.wire_resid_host()}


def _eval_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """sBN, Local and Global on ``job['params']`` with the evaluation
    operands of ``job['operands']``, host path and fused -> both results."""
    from heterofl_tpu_torch.convert import params_from_jax
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.ops.fused_update import FlatSpec
    from heterofl_tpu_torch.parallel.evaluation import Evaluator
    from heterofl_tpu_torch.parallel.staging import host_fetch

    cfg = job["cfg"]
    model = make_model(cfg)
    model.load_state_dict(params_from_jax(job["params"], model.jax_perms()))
    model = model.to(mesh.device)
    ev = Evaluator(model, cfg, mesh.device, seed=0, mesh=mesh)
    dev = lambda ops: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)  # noqa: E731
                            for a in ops)
    params = model.params()
    out: Dict[str, Any] = {}
    glob = dev(job["global"])
    if job.get("sbn") is not None:
        sbn, local = dev(job["sbn"]), dev(job["local"])
        bn = ev.sbn_stats(params, *sbn)
        out["bn"] = {k: (_host(m), _host(v)) for k, (m, v) in bn.items()}
        out["local"] = ev.eval_users(params, bn, *local)
        out["global"] = ev.eval_global(params, bn, *glob, epoch=job.get("epoch", 1))
        fused = ev.fused(FlatSpec.of(params), sbn, local, glob)
    else:
        out["global"] = ev.eval_global(params, {}, *glob, epoch=job.get("epoch", 1))
        fused = ev.fused(FlatSpec.of(params), global_eval=glob)
    res = fused.run(FlatSpec.of(params).flatten({k: v.detach() for k, v in params.items()}),
                    job.get("epoch", 1))
    out["fused"] = fused.assemble([host_fetch(res)], [job.get("epoch", 1)])[0]
    return out


def _entry_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """The federated entry's ``main(job['argv'])`` (every rank) -> its
    result's params, history and residual."""
    import importlib

    entry = importlib.import_module(f"heterofl_tpu_torch.entry.{job['entry']}")
    (res,) = entry.main(job["argv"])
    return {"params": {k: _host(v) for k, v in res["params"].items()},
            "history": res["history"], "wire_resid": res["wire_resid"]}


def job_main(path: str) -> None:
    """One rank of :func:`run_ranks`: join the group, run the job
    (``deterministic``: under ``torch.use_deterministic_algorithms``),
    pickle its result to ``rank<r>.pkl``."""
    import torch

    from heterofl_tpu_torch.parallel import mesh as M

    torch.set_num_threads(1)
    with open(path, "rb") as f:
        job = pickle.load(f)
    if job.get("deterministic"):
        torch.use_deterministic_algorithms(True)
    M.initialize_distributed(device="cpu")
    mesh = M.make_mesh(0, device=torch.device("cpu"))
    M.reset_counts()
    fn = {"round": _round_job, "eval": _eval_job, "entry": _entry_job}[job["kind"]]
    out = fn(job, mesh, torch)
    out["collectives"] = dict(M.COLLECTIVES)
    with open(os.path.join(job["out_dir"], f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    M.shutdown_distributed()


if __name__ == "__main__":
    job_main(sys.argv[1])
