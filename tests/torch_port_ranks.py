"""Work a rank for the two-rank tests: :func:`run_ranks` runs a job (a
masked or grouped round with its draws handed in, a grouped superstep, an
evaluation, an entry, the pod probe's rank, or several of them in turn on
one group) as
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


def grouped_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """A grouped round of ``job['cfg']`` (or, with ``job['engine']``
    ``'sliced'``, the sliced twin's, which every rank runs whole) from
    reference-layout ``params`` on ``data`` -> the new params (reference
    layout and flat), the metric sums (K=1: one round's dict; ``k``: the
    superstep's rounds), the residual, the placement and its slices table.
    K=1 (``users``, ``epoch_perms`` ``{uid: [E, N]}``) or, with ``k``, one
    superstep of the ``[k, A]`` ``users`` and ``rates`` at ``seed`` from
    ``epoch0`` (default 1), its draws handed in where given: ``epoch_perms``
    a round each, ``codec_noise`` a rank each, a round each; with
    ``first_round`` also the params after round 1 alone on the superstep's
    grid (``first``), which size round 2's grid step.  Also the one-rank
    run, called in the test's process with a one-rank mesh."""
    from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
    from heterofl_tpu_torch.fed.sliced import SlicedFederation
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import GroupedRoundEngine

    cfg = job["cfg"]
    model = make_model(cfg)
    perms = model.jax_perms()
    model.load_state_dict(params_from_jax(job["params"], perms))
    model = model.to(mesh.device)
    if job.get("engine") == "sliced":
        eng = SlicedFederation(model, cfg, mesh.device)
    else:
        eng = GroupedRoundEngine(model, cfg, mesh.device, mesh)
    data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device) for a in job["data"])
    P = eng.flatten(model.params())
    out: Dict[str, Any] = {}
    if job.get("k"):
        k, eperms, noise = job["k"], job.get("epoch_perms"), job.get("codec_noise")
        if noise is not None:  # this rank's, a round each: int8 noise, or {rate: noise}
            dev = lambda a: torch.from_numpy(a).to(mesh.device)  # noqa: E731
            noise = [{r: dev(a) for r, a in n.items()} if isinstance(n, dict) else dev(n)
                     for n in noise[mesh.rank]]
        if job.get("first_round"):  # round 1 alone on the superstep's grid
            P1, _ = eng._train_round(P.clone(), job["lr"], job["users"][0], data, 0, eperms[0],
                                     None, job["rates"][0], None, codec_noise=noise[0],
                                     codec_slots=eng.codec_slots(job["rates"]))
            eng.reset_carries()
            out["first"] = _host(P1)
        P, pend = eng.train_superstep(P, job["seed"], job.get("epoch0", 1), k, data,
                                      job["users"], job["rates"],
                                      np.full(k, job["lr"], np.float32), epoch_perms=eperms,
                                      codec_noise=noise)
        rounds = [{n: np.asarray(v) for n, v in r.items()} for r in pend.fetch()]
    else:
        P, ms = eng.train_round(P, job["lr"], job["users"], data, round_seed=0,
                                epoch_perms=job.get("epoch_perms"))
        rounds = {n: (_host(v) if torch.is_tensor(v) else v) for n, v in ms.items()}
    return dict(out, round=rounds, params=params_to_jax(eng.unflatten(P), perms), flat=_host(P),
                resid=eng.wire_resid_host(), placement=getattr(eng, "level_placement", None),
                slices=dict(getattr(eng, "slices", {})))


def _seq_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """Each job of ``job['jobs']`` in turn on the same group (a probe,
    which leaves the group, only last) -> their results, each with the
    collectives it made."""
    from heterofl_tpu_torch.parallel import mesh as M

    out = []
    for sub in job["jobs"]:
        M.reset_counts()
        res = JOBS[sub["kind"]](dict(sub, out_dir=job["out_dir"]), mesh, torch)
        res["collectives"] = dict(M.COLLECTIVES)
        out.append(res)
    return {"results": out}


def _probe_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """The pod probe's rank (``pod.child_main``, the grouped slices
    superstep), which leaves the group at its end."""
    from heterofl_tpu_torch.parallel import pod

    return pod.child_main(os.path.join(job["out_dir"], "probe"), backend="gloo", device="cpu")


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
    pickle its result to ``rank<r>.pkl`` with the collectives it made and
    the modules of ``jax``, ``jaxlib`` and ``heterofl_tpu`` it loaded."""
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
    out = JOBS[job["kind"]](job, mesh, torch)
    out["collectives"] = dict(M.COLLECTIVES)
    out["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "heterofl_tpu"))
    with open(os.path.join(job["out_dir"], f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    M.shutdown_distributed()


JOBS = {"round": _round_job, "eval": _eval_job, "entry": _entry_job, "grouped": grouped_job,
        "seq": _seq_job, "probe": _probe_job}


if __name__ == "__main__":
    job_main(sys.argv[1])
