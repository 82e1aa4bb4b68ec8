"""The pod probe: the grouped engine's slices superstep (or the masked
engine's) on a real multi-process group.

Port of ``heterofl_tpu/parallel/pod.py`` (``child_main``,
``run_pod_probe``, ``bitwise_match``, ``_free_port``).  Each child process
joins the ``torch.distributed`` group (:func:`~.mesh.initialize_distributed`,
from the variables torchrun would set), builds the clients mesh over every
rank, trains a K-round superstep on a small synthetic federation, times a
second superstep, writes a sharded checkpoint (each rank its own residual
row, rank 0 the header) and reads it back.  The engine is the reference's
(pod.py:94-160): the grouped engine under ``level_placement='slices'`` with
``strict_placement`` on :data:`PROBE_CONTROL`'s two levels, each level on
its own block of ranks, its slices table recorded; ``--engine masked`` runs
the masked engine instead.  Every rank writes its params and per-round
metrics as ``.npz`` under ``rank<r>/`` (:func:`rank_dir`) and
``pod_result_p<rank>.json`` with the collectives and kernel launches it
counted over both supersteps and its timings.  :func:`run_pod_probe`
spawns the children; :func:`bitwise_match` compares two ranks' files bit
for bit and :func:`compare_probes` holds a run at several ranks against
the one-process run -- for the grouped engine that run is ``span``, the
one placement one rank can lay out (the reference pins the slices table
on one process with ``slice_align``, which needs several devices there).

Run it as ``python -m heterofl_tpu_torch.parallel.pod OUT_DIR --spawn 2``
(two ranks and the one-process run, compared; ``--backend gloo --device
cuda`` puts two ranks on one GPU, where NCCL refuses to: gloo reduces the
CUDA buffers itself, :func:`gloo_cuda_check`), or as one child under
torchrun.

:func:`_spawn` starts any command as the ranks of one group, as torchrun
would (the tests' rounds, evaluations and entries; ``chip_smoke.py``'s
two ranks of the entry).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

#: the probe's federation: two levels, 8 users, 4 a round
PROBE_CONTROL = "1_8_0.5_iid_fix_a1-b1_bn_1_1"
PROBE_USERS = 8
#: the probe's engines: the reference's grouped slices superstep, and the masked one
PROBE_ENGINES = ("grouped", "masked")
#: ranks against the one-process run: the round's sums associate by rank
#: ((c0 + c1) + (c2 + c3) against ((c0 + c1) + c2) + c3), a float32
#: rounding apart, which k local-SGD rounds carry into the params
RANKS_ATOL = 1e-5


def _host(t) -> np.ndarray:
    """A tensor's host copy: the probe's results, read once
    at their end."""
    # staticcheck: allow(no-device-get) a result read after its run, not a round's read
    return t.detach().cpu().numpy()


def _clock() -> float:
    """The host clock: the probe's timings, between dispatches."""
    # staticcheck: allow(no-wallclock) timed between dispatches, outside any step
    return time.perf_counter()


def rank_dir(out_dir: str, rank: int) -> str:
    """Where rank ``rank`` of a probe run writes ``params.npz`` and
    ``metrics.npz``."""
    return os.path.join(out_dir, f"rank{rank}")


def probe_cfg(control: str = PROBE_CONTROL, device: str = "cpu", codec: str = "dense",
              sizes: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """The probe's processed cfg: the conv net at widths 8/16 on synthetic
    MNIST (the reference's probe shapes)."""
    from .. import config as C

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(control)
    cfg.update(data_name="MNIST", model_name="conv", device=device, synthetic=True,
               wire_codec=codec, synthetic_sizes=sizes or {"train": 400, "test": 100},
               pallas_norm=True,
               override={"conv": {"hidden_size": [8, 16]},
                         "num_epochs": {"global": 8, "local": 1}})
    cfg = C.process_control(cfg)
    cfg["classes_size"] = 10
    return cfg


def probe_data(cfg: Dict[str, Any], users: int = PROBE_USERS):
    """Every user's train stacks and label masks (numpy, seed 0): every
    process builds the same arrays."""
    from ..data import fetch_dataset, label_split_masks, split_dataset, stack_client_shards

    ds = fetch_dataset(cfg["data_name"], synthetic=True, seed=0,
                       synthetic_sizes=cfg["synthetic_sizes"])
    # staticcheck: allow(no-fresh-rng) the probe's data seed, not an engine stream
    rng = np.random.default_rng(0)
    split, lsplit = split_dataset(ds, users, cfg["data_split_mode"], rng, classes_size=10)
    x, y, m = stack_client_shards(ds["train"].data, ds["train"].target, split["train"],
                                  list(range(users)))
    return x, y, m, label_split_masks(lsplit, users, 10)


def _schedules(cfg: Dict[str, Any], epoch0: int, k: int, num_active: int):
    """The ``[k, A]`` cohorts and rates of rounds ``epoch0..``: the ``prp``
    draws of the port's round seeds, the same on every process."""
    from ..fed.core import superstep_rate_schedule, superstep_user_schedule

    users = superstep_user_schedule(0, epoch0, k, cfg["num_users"], num_active, "prp")
    return users, superstep_rate_schedule(0, epoch0, k, cfg, users)


def _launch_counters():
    """The kernels' launch counters (each wrapper adds one a launch)."""
    from ..ops import fused_norm, fused_update, quant

    return fused_norm.LAUNCHES, fused_update.LAUNCHES, quant.LAUNCHES


def child_main(out_dir: str, k: int = 2, num_active: int = 4, backend: Optional[str] = None,
               device: str = "cpu", codec: str = "dense", engine: str = "grouped"
               ) -> Dict[str, Any]:
    """One rank of the probe (or the one-process run, without torchrun's
    variables) -> its result dict, also written as
    ``pod_result_p<rank>.json``.  ``engine='grouped'`` runs the grouped
    engine under ``slices`` with ``strict_placement`` at several ranks (its
    slices table under ``"slices"``) and under ``span`` on one."""
    import torch

    from ..models import make_model
    from ..utils.checkpoint import (dense_from_blocks, is_shard_marker, load_checkpoint_sharded,
                                    rank_block_marker, save_checkpoint_sharded)
    from . import mesh as M
    from .grouped import GroupedRoundEngine
    from .round_engine import RoundEngine

    torch.set_num_threads(1)
    if torch.device(device).type == "cuda":  # the ranks against one rank: repeatable convs
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    M.initialize_distributed(backend, device)
    mesh = M.make_mesh(0, device=torch.device(device))
    out: Dict[str, Any] = {"process": mesh.rank, "processes": mesh.size,
                           "backend": mesh.backend, "k": k, "codec": codec, "engine": engine}
    if mesh.backend == "gloo" and mesh.device.type == "cuda":
        out["gloo_cuda_direct"] = gloo_cuda_check(mesh)
    cfg = probe_cfg(device=device, codec=codec)
    model = make_model(cfg).init_(torch.Generator().manual_seed(0)).to(mesh.device)
    if engine == "grouped":
        sliced = mesh.size > 1
        cfg.update(strategy="grouped", level_placement="slices" if sliced else "span",
                   strict_placement=sliced)
        eng = GroupedRoundEngine(model, cfg, mesh.device, mesh)
        out["placement"] = eng.level_placement
        out["slices"] = {f"{r:g}": list(lh) for r, lh in eng.slices.items()}
    elif engine == "masked":
        eng = RoundEngine(model, cfg, mesh.device, mesh)
    else:
        raise ValueError(f"Not valid probe engine: {engine!r} (one of {PROBE_ENGINES})")
    data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
                 for a in probe_data(cfg))
    P = eng.flatten(model.params())
    lrs = np.full(k, 0.05, np.float32)
    M.reset_counts()
    counters = _launch_counters()
    for c in counters:
        c.update({name: 0 for name in c})
    users, rates = _schedules(cfg, 1, k, num_active)
    P, pend = eng.train_superstep(P, 0, 1, k, data, users, rates, lrs)
    ms = pend.fetch()
    out["all_reduce_per_round"] = M.COLLECTIVES["all_reduce"] / k
    out["gathers"] = M.COLLECTIVES["gather"]
    out["all_reduce_bytes_per_round"] = M.COLLECTIVE_BYTES["all_reduce"] // k
    users2, rates2 = _schedules(cfg, 1 + k, k, num_active)
    t0 = _clock()
    P, pend2 = eng.train_superstep(P, 0, 1 + k, k, data, users2, rates2, lrs)
    ms2 = pend2.fetch()  # waits for the superstep's last kernel
    out["superstep_s"] = _clock() - t0
    out["rounds_per_sec"] = k / out["superstep_s"]
    out["launches"] = {name: n for c in counters for name, n in c.items()}
    # a sharded checkpoint: this rank's residual row (the int8 codec's, or
    # a row of its own values), rank 0 the header
    resid = eng.wire_resid_host()
    if resid is None:
        # staticcheck: allow(no-fresh-rng) a checkpoint row's values, not an engine stream
        resid = np.random.default_rng(7 + mesh.rank).normal(size=(1, 32)).astype(np.float32)
    ck = os.path.join(out_dir, "ckpt", "probe.ckpt")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    host_params = {n: _host(v) for n, v in eng.unflatten(P).items()}
    marker = rank_block_marker(resid, mesh.rank, mesh.size) if mesh.size > 1 else resid[None]
    t0 = _clock()
    save_checkpoint_sharded(ck, {"epoch": 2 * k, "params": host_params, "resid": marker},
                            mesh=mesh)
    out["ckpt_write_s"] = _clock() - t0
    back = load_checkpoint_sharded(ck)["resid"]
    if is_shard_marker(back):
        back = dense_from_blocks(back)
    out["sharded_ckpt_ok"] = bool(back.shape[0] == mesh.size
                                  and np.array_equal(back[mesh.rank], resid))
    mine = rank_dir(out_dir, mesh.rank)
    os.makedirs(mine, exist_ok=True)
    np.savez(os.path.join(mine, "params.npz"), **host_params)
    np.savez(os.path.join(mine, "metrics.npz"),
             **{f"r{r}_{name}": np.asarray(v)
                for r, md in enumerate(list(ms) + list(ms2)) for name, v in md.items()})
    out["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "heterofl_tpu"))
    with open(os.path.join(out_dir, f"pod_result_p{mesh.rank}.json"), "w") as f:
        json.dump(out, f, sort_keys=True)
    M.shutdown_distributed()
    return out


def gloo_cuda_check(mesh) -> str:
    """Whether this PyTorch's gloo all-reduces a CUDA tensor itself: every
    rank all-reduces a small CUDA tensor directly (outside the wrapper) and
    records what came of it.  Nothing is switched on the answer: the
    wrappers hand gloo their CUDA tensors as they are (``parallel/mesh.py``),
    which this check and the probe's rounds show it takes."""
    import torch
    import torch.distributed as dist

    t = torch.ones(4, device=mesh.device)
    try:
        dist.all_reduce(t, group=mesh.group)
    except (RuntimeError, ValueError) as e:  # recorded, never acted on
        return f"no: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    got = _host(t)
    return "yes" if np.all(got == mesh.size) else f"wrong sum {[float(x) for x in got]}"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(argv: List[str], n_processes: int, timeout_s: int, gpus: int = 0) -> List[str]:
    """Run ``argv`` as ``n_processes`` ranks of one group (torchrun's
    variables set by hand, a free port each run; ``n_processes`` 1 runs it
    alone, with no group), each rank's ``LOCAL_RANK`` its GPU when there
    are ``gpus`` of them, else 0 -> each rank's standard output.  A rank
    that fails, or outlives ``timeout_s``, stops them all and raises."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(v, None)
    port = str(_free_port())
    procs = []
    for i in range(n_processes):
        e = dict(env)
        if n_processes > 1:
            e.update(RANK=str(i), WORLD_SIZE=str(n_processes),
                     LOCAL_RANK=str(i if gpus >= n_processes else 0),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(argv, env=e, text=True, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    deadline = _clock() + timeout_s
    failed, outs = None, []
    for i, pr in enumerate(procs):
        try:
            so, se = pr.communicate(timeout=max(1.0, deadline - _clock()))
        except subprocess.TimeoutExpired:
            failed = f"rank {i} timed out after {timeout_s} s"
            break
        outs.append(so)
        if pr.returncode != 0:
            failed = f"rank {i} failed (rc={pr.returncode}):\n{se[-3000:]}"
            break
    if failed is not None:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        raise RuntimeError(f"pod run: {failed}")
    return outs


def run_pod_probe(out_dir: str, n_processes: int = 2, k: int = 2, num_active: int = 4,
                  backend: Optional[str] = None, device: str = "cpu", codec: str = "dense",
                  timeout_s: int = 600, gpus: int = 0, engine: str = "grouped"
                  ) -> List[Dict[str, Any]]:
    """Spawn ``n_processes`` probe children over one group (1: the
    one-process run, no group) -> their result dicts, by rank."""
    os.makedirs(out_dir, exist_ok=True)
    argv = [sys.executable, "-m", "heterofl_tpu_torch.parallel.pod", out_dir, "--k", str(k),
            "--active", str(num_active), "--device", device, "--codec", codec,
            "--engine", engine]
    if backend:
        argv += ["--backend", backend]
    _spawn(argv, n_processes, timeout_s, gpus)
    results = []
    for i in range(n_processes):
        with open(os.path.join(out_dir, f"pod_result_p{i}.json")) as f:
            results.append(json.load(f))
    return results


def bitwise_match(dir_a: str, dir_b: str) -> Dict[str, Any]:
    """Compare two probe directories' ``params.npz`` and ``metrics.npz`` bit
    for bit -> ``{"match": bool, "mismatches": [...]}``."""
    mismatches = []
    for fname in ("params.npz", "metrics.npz"):
        a = np.load(os.path.join(dir_a, fname))
        b = np.load(os.path.join(dir_b, fname))
        if sorted(a.files) != sorted(b.files):
            mismatches.append(f"{fname}: key sets differ")
            continue
        for kk in a.files:
            if not np.array_equal(a[kk], b[kk]):
                mismatches.append(f"{fname}:{kk}")
    return {"match": not mismatches, "mismatches": mismatches}


def max_abs_diff(dir_a: str, dir_b: str) -> Dict[str, float]:
    """The largest absolute difference of the two probe directories'
    params and metric sums."""
    out = {}
    for fname in ("params.npz", "metrics.npz"):
        a, b = np.load(os.path.join(dir_a, fname)), np.load(os.path.join(dir_b, fname))
        out[fname.split(".")[0]] = max(
            [0.0] + [float(np.max(np.abs(a[kk].astype(np.float64) - b[kk])))
                     for kk in a.files if a[kk].size])
    return out


def compare_probes(many: str, res: List[Dict[str, Any]], one: str,
                   res1: List[Dict[str, Any]]) -> Dict[str, Any]:
    """A probe run at several ranks (directory ``many``, results ``res``)
    against the one-process run (``one``, ``res1``) -> ``{"ranks_equal",
    "all_reduce_per_round", "vs_one_rank": {params, metrics} max abs
    diffs, "within_tolerance", "sharded_ckpt_ok", "results",
    "one_rank"}``: every rank's params and metrics bit for bit rank 0's
    (:func:`bitwise_match`), one all-reduce a round, rank 0's params within
    :data:`RANKS_ATOL` of the one-process run's; each rank's placement and
    rank 0's slices table (the grouped engine's)."""
    base = rank_dir(many, 0)
    diff = max_abs_diff(base, rank_dir(one, 0))
    return {"ranks_equal": all(bitwise_match(base, rank_dir(many, r["process"]))["match"]
                               for r in res),
            "all_reduce_per_round": [r["all_reduce_per_round"] for r in res],
            "vs_one_rank": diff, "within_tolerance": diff["params"] <= RANKS_ATOL,
            "sharded_ckpt_ok": all(r["sharded_ckpt_ok"] for r in res),
            "placements": [r.get("placement") for r in res], "slices": res[0].get("slices"),
            "results": res, "one_rank": res1}


def probe_ranks(out_dir: str, n_processes: int = 2, backend: Optional[str] = None,
                device: str = "cpu", codec: str = "dense", k: int = 2,
                timeout_s: int = 600, gpus: int = 0, engine: str = "grouped") -> Dict[str, Any]:
    """The probe at ``n_processes`` ranks and alone, compared
    (:func:`compare_probes`)."""
    many, one = os.path.join(out_dir, f"ranks{n_processes}"), os.path.join(out_dir, "ranks1")
    res = run_pod_probe(many, n_processes, k=k, backend=backend, device=device, codec=codec,
                        timeout_s=timeout_s, gpus=gpus, engine=engine)
    res1 = run_pod_probe(one, 1, k=k, device=device, codec=codec, timeout_s=timeout_s,
                         engine=engine)
    return compare_probes(many, res, one, res1)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="The pod probe: the grouped engine's slices "
                                 "superstep (or the masked engine's) on a multi-process "
                                 "torch.distributed group.")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--active", type=int, default=4)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--codec", default="dense")
    ap.add_argument("--engine", choices=PROBE_ENGINES, default="grouped")
    ap.add_argument("--spawn", type=int, default=0,
                    help="run the probe at this many ranks and alone, and compare")
    a = ap.parse_args(argv)
    if a.out_dir is None:
        ap.error("OUT_DIR is required")
    if a.spawn:
        import torch

        gpus = torch.cuda.device_count() if a.device == "cuda" else 0
        res = probe_ranks(a.out_dir, a.spawn, a.backend, a.device, a.codec, a.k, gpus=gpus,
                          engine=a.engine)
        print(json.dumps({k: v for k, v in res.items() if k not in ("results", "one_rank")},
                         sort_keys=True))
        ok = res["ranks_equal"] and res["within_tolerance"] and res["sharded_ckpt_ok"] and \
            all(n == 1 for n in res["all_reduce_per_round"]) and \
            (a.engine != "grouped" or a.spawn < 2 or
             all(p == "slices" for p in res["placements"]))
        return 0 if ok else 1
    print(json.dumps(child_main(a.out_dir, a.k, a.active, a.backend, a.device, a.codec,
                                a.engine), sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
