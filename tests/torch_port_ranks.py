"""Work a rank for the two-rank tests: :func:`run_ranks` runs a job (a
masked or grouped round with its draws handed in, a grouped or masked
superstep, an evaluation, an entry, the pod probe's rank, the synchronised
batch norm of one client or of a level's G clients, ring attention,
``SeqParallelLM``, or several of them in turn on one group, each on a
``(clients, data)`` mesh of its own) as
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
    grid (``first``), which size round 2's grid step.  K=1 also takes the
    reference's whole-batch augmentation ``aug_draws`` ``{(uid, t):
    (offsets, flips)}`` and LM draws ``lm_draws`` ``{(uid, t): draws}``.
    Also the one-rank run, called in the test's process with a one-rank
    mesh."""
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
        aug, lmd = job.get("aug_draws"), job.get("lm_draws")
        hooks = {} if aug is None else {"aug_draws": lambda u, t: aug[u, t]}
        if lmd is not None:
            hooks["lm_draws"] = lambda u, t: {
                k: ({s: torch.from_numpy(np.asarray(m)) for s, m in v.items()}
                    if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
                for k, v in lmd[u, t].items()}
        P, ms = eng.train_round(P, job["lr"], job["users"], data, round_seed=0,
                                epoch_perms=job.get("epoch_perms"), **hooks)
        rounds = {n: (_host(v) if torch.is_tensor(v) else v) for n, v in ms.items()}
    return dict(out, round=rounds, params=params_to_jax(eng.unflatten(P), perms), flat=_host(P),
                resid=eng.wire_resid_host(), placement=getattr(eng, "level_placement", None),
                slices=dict(getattr(eng, "slices", {})))


def _seq_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """Each job of ``job['jobs']`` in turn on the same group (a probe,
    which leaves the group, only last), a job with ``n_data`` on its own
    ``(world / n_data, n_data)`` mesh -> their results, each with the
    collectives it made."""
    from heterofl_tpu_torch.parallel import mesh as M

    out = []
    for sub in job["jobs"]:
        m = mesh if "n_data" not in sub else M.make_mesh(0, sub["n_data"],
                                                          device=torch.device("cpu"))
        M.reset_counts()
        res = JOBS[sub["kind"]](dict(sub, out_dir=job["out_dir"]), m, torch)
        res["collectives"] = dict(M.COLLECTIVES)
        res["data_collectives"] = dict(M.DATA_COLLECTIVES)
        res["data_collective_bytes"] = dict(M.DATA_COLLECTIVE_BYTES)
        out.append(res)
    return {"results": out}


def _bn_sync_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """The synchronised batch norm on this rank's data block of the NHWC
    batch ``x`` (weights ``w``, cotangent ``dy``) -> its ``y``, and the
    gradients of ``sum(y * dy)``: ``dx`` of its block, its LOCAL ``dg``
    and ``db``."""
    from heterofl_tpu_torch.ops.layers import batch_norm
    from heterofl_tpu_torch.parallel.mesh import block_bounds

    lo, hi = block_bounds(job["x"].shape[0], mesh.data_size, mesh.data_rank)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    x = t(job["x"][lo:hi]).permute(0, 3, 1, 2).requires_grad_()
    g, b = t(job["g"]).requires_grad_(), t(job["b"]).requires_grad_()
    y, _ = batch_norm(x, g, b, sample_weight=t(job["w"][lo:hi]), group=mesh)
    dx, dg, db = torch.autograd.grad((y * t(job["dy"][lo:hi]).permute(0, 3, 1, 2)).sum(),
                                     (x, g, b))
    return {"y": _host(y.permute(0, 2, 3, 1)), "dx": _host(dx.permute(0, 2, 3, 1)),
            "dg": _host(dg), "db": _host(db)}


def _bn_sync_clients_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """The batched synchronised batch norm of G clients on this rank's data
    block of ``x [G, N, H, W, C]`` (weights ``w [G, N]``, cotangent ``dy``),
    as the grouped engine's clients-in-channels ``[n, G*C, H, W]`` -> its
    ``y``, and the gradients of ``sum(y * dy)``: ``dx`` of its block, its
    LOCAL ``dg`` and ``db`` ``[G, C]``, each in the input's layout; at G = 1
    also the one-client ``batch_norm_sync``'s, which it must equal bit for
    bit."""
    from heterofl_tpu_torch.ops.fused_norm import batch_norm_sync, batch_norm_sync_clients
    from heterofl_tpu_torch.parallel.mesh import block_bounds

    G, N, H, W, C = job["x"].shape
    lo, hi = block_bounds(N, mesh.data_size, mesh.data_rank)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

    def clients(a):  # [G, n, H, W, C] -> [n, G*C, H, W] (channels_last)
        return a.permute(1, 2, 3, 0, 4).reshape(a.shape[1], H, W, G * C).permute(0, 3, 1, 2)

    def back(a):  # the inverse
        return a.permute(0, 2, 3, 1).reshape(a.shape[0], H, W, G, C).permute(3, 0, 1, 2, 4)

    x = clients(t(job["x"][:, lo:hi])).detach().requires_grad_()
    g, b = t(job["g"]).requires_grad_(), t(job["b"]).requires_grad_()
    dy = clients(t(job["dy"][:, lo:hi]))
    y = batch_norm_sync_clients(x, g, b, t(job["w"][:, lo:hi]), mesh)
    dx, dg, db = torch.autograd.grad((y * dy).sum(), (x, g, b))
    out = {"y": _host(back(y)), "dx": _host(back(dx)), "dg": _host(dg), "db": _host(db)}
    if G == 1:
        x1 = x.detach().requires_grad_()
        g1, b1 = g.detach()[0].requires_grad_(), b.detach()[0].requires_grad_()
        y1 = batch_norm_sync(x1, g1, b1, t(job["w"][0, lo:hi]), mesh)
        dx1, dg1, db1 = torch.autograd.grad((y1 * dy).sum(), (x1, g1, b1))
        out["one"] = {"y": _host(back(y1)), "dx": _host(back(dx1)), "dg": _host(dg1[None]),
                      "db": _host(db1[None])}
    return out


def _layout_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """This rank's place on the mesh, its flat axis, and its world rank
    summed over each axis and shifted round its data ring."""
    t = torch.tensor([float(mesh.world_rank)])
    flat = mesh.flat()
    return {"coords": [mesh.rank, mesh.size, mesh.data_rank, mesh.data_size, mesh.world_rank,
                       mesh.world_size, mesh.lead], "flat": [flat.rank, flat.size],
            "sum_data": int(mesh.all_reduce_sum([t], axis="data")[0]),
            "sum_clients": int(mesh.all_reduce_sum([t])[0]),
            "sum_world": int(mesh.all_reduce_sum([t], axis="world")[0]),
            "shifted": int(mesh.ring_shift([t])[0])}


def _ring_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """Ring attention of this rank's data block of ``q``, ``k``, ``v``
    (``[h, S, d]``, split on S) -> its output and the gradients of the
    whole sequence's ``sum(out ** 2)`` for its blocks (each rank
    differentiates its own part; the ring carries the rest)."""
    from heterofl_tpu_torch.parallel.mesh import block_bounds
    from heterofl_tpu_torch.parallel.ring_attention import ring_attention

    lo, hi = block_bounds(job["q"].shape[-2], mesh.data_size, mesh.data_rank)
    q, k, v = (torch.from_numpy(np.ascontiguousarray(job[n][..., lo:hi, :])).requires_grad_()
               for n in "qkv")
    out = ring_attention(q, k, v, mesh, job["temp"])
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    return {"out": _host(out), "grads": [_host(g) for g in grads]}


def _seqlm_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """``SeqParallelLM`` of ``job['cfg']`` from reference-layout ``params``:
    ``forward`` on ``labels`` with the whole-window corruption
    ``draws['fwd']``, then ``train_step`` at ``lr`` with ``draws['step']``
    -> the loss, the step's loss and new params (reference layout)."""
    from heterofl_tpu_torch.convert import params_from_jax, params_to_jax
    from heterofl_tpu_torch.parallel.long_context import SeqParallelLM

    lm = SeqParallelLM(job["cfg"], mesh)
    perms = lm.model.jax_perms()
    params = {k: v.to(mesh.device) for k, v in params_from_jax(job["params"], perms).items()}
    labels = torch.from_numpy(np.ascontiguousarray(job["labels"]))
    dr = {k: {"corrupt": torch.from_numpy(v)} for k, v in job["draws"].items()}
    loss = lm.forward(params, labels, draws=dr["fwd"])
    new, _, step_loss = lm.train_step(params, lm.init_opt(params), labels, job["lr"],
                                      draws=dr["step"])
    return {"loss": float(loss), "step_loss": float(step_loss),
            "params": params_to_jax({k: v.detach() for k, v in new.items()}, perms)}


def _superstep_job(job: Dict[str, Any], mesh, torch) -> Dict[str, Any]:
    """The masked (or, with ``job['engine']`` ``'grouped'``, the grouped)
    engine's ``train_superstep`` of ``k`` rounds (cohorts ``users [k, A]``
    at ``rates``) against the same rounds one after another through
    ``train_round`` at each round's seed -> both flat params and metric
    rows."""
    from heterofl_tpu_torch.convert import params_from_jax
    from heterofl_tpu_torch.fed.core import round_seed
    from heterofl_tpu_torch.models import make_model
    from heterofl_tpu_torch.parallel import GroupedRoundEngine
    from heterofl_tpu_torch.parallel.round_engine import RoundEngine

    cfg, k = job["cfg"], job["k"]
    model = make_model(cfg)
    model.load_state_dict(params_from_jax(job["params"], model.jax_perms()))
    engine = GroupedRoundEngine if job.get("engine") == "grouped" else RoundEngine
    eng = engine(model, cfg, mesh.device, mesh)
    data = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in job["data"])
    P0 = eng.flatten(model.params())
    lrs = np.full(k, job["lr"], np.float32)
    P, seq = P0.clone(), []
    for r in range(k):
        P, ms = eng.train_round(P, float(lrs[r]), job["users"][r], data, round_seed(0, 1 + r),
                                rates=job["rates"][r])
        seq.append({n: _host(ms[n]) for n in ("loss_sum", "score_sum", "n")})
    P2, pend = eng.train_superstep(P0.clone(), 0, 1, k, data, job["users"], job["rates"], lrs)
    fetched = pend.fetch()
    return {"seq": _host(P), "superstep": _host(P2), "seq_rows": seq,
            "superstep_rows": [{n: np.asarray(f[n]) for n in ("loss_sum", "score_sum", "n")}
                               for f in fetched]}


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
    mesh = M.make_mesh(0, job.get("n_data", 1), device=torch.device("cpu"))
    M.reset_counts()
    out = JOBS[job["kind"]](job, mesh, torch)
    out["collectives"] = dict(M.COLLECTIVES)
    out["data_collectives"] = dict(M.DATA_COLLECTIVES)
    out["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "heterofl_tpu"))
    with open(os.path.join(job["out_dir"], f"rank{mesh.world_rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    M.shutdown_distributed()


JOBS = {"round": _round_job, "eval": _eval_job, "entry": _entry_job, "grouped": grouped_job,
        "seq": _seq_job, "probe": _probe_job, "bn_sync": _bn_sync_job, "ring": _ring_job,
        "seqlm": _seqlm_job, "superstep": _superstep_job, "layout": _layout_job,
        "bn_sync_clients": _bn_sync_clients_job}


if __name__ == "__main__":
    job_main(sys.argv[1])
