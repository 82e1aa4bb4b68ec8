"""``python -m heterofl_tpu_torch.chaos.drill`` -- run the experiment loop under a
fault plan and hold the recovery contract.

Port of ``heterofl_tpu/chaos/drill.py``:

* **kill drills** (:func:`run_kill_drill`): a small synthetic federation
  run uninterrupted, then again with a :class:`~heterofl_tpu_torch.chaos.
  FaultInjector` killing it at the planned loop boundaries (and the
  plan's checkpoint corruptions applied between the first kill and its
  resume), a FRESH experiment resumed from disk after every kill.
  Contract: the recovered run's final params equal the uninterrupted
  run's bit for bit -- every per-round draw descends from (seed, round),
  and a resume starts at a checkpointed boundary with its carries.
* **poison drills** (:func:`run_poison_drill`): a drawn (round, uid) client
  update made NaN, and the run completes without intervention -- the
  quarantine gate zeroes the update (``quarantine``), or the watchdog's
  ``rollback`` restores the last good generation and replays the rounds on
  a salted stream (``rollback``).  :func:`pick_poison_uid` picks a uid the
  poisoned round draws and no salted retry of it draws, from the port's own
  ``prp`` map and round-seed stream, so the recovery is certain.

Both runs of a drill go under cuDNN's deterministic algorithms
(``torch.backends.cudnn.deterministic``, put back after): under the
default algorithms a masked round on a GPU is not repeatable run to run,
so no resume could equal the uninterrupted run.  The report says so
(``cudnn_deterministic``).  A kill on the GPU leaves the dead run's CUDA
graphs, cohort ring and staged fetch behind: the drill drops the kill's
traceback and collects them before the resume, outside any capture.

Exit code 0 iff every drilled contract holds; the report is one JSON
object on stdout (``--json``) or a line a drill.  The drill runs on
``cuda`` unless ``--device cpu``; ``--control``, ``--data``, ``--model``
and ``--override`` set the federation (by default the small one of
:func:`drill_cfg`).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

DRILL_CONTROL = "1_8_0.5_iid_fix_a1-b1_bn_1_1"


def drill_cfg(out_dir: str, device: str = "cuda", control: str = DRILL_CONTROL,
              data_name: str = "MNIST", model_name: str = "conv",
              sizes: Optional[Dict[str, int]] = None, **over) -> Dict[str, Any]:
    """The drill's federation (ref drill.py:56-81): by default 8 users, two
    rate levels, conv widths 4/8, 4 rounds in supersteps of 2, evaluated
    every 2; ``over`` overrides any of it (``num_epochs``, widths,
    ``strategy``, ``client_store``, ...).  ``sampler='prp'`` is pinned: the
    ``perm`` stream is stateful, so :func:`pick_poison_uid` could not
    predict its draws."""
    from .. import config as C

    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(control)
    cfg.update(data_name=data_name, model_name=model_name, synthetic=True, device=device,
               synthetic_sizes=sizes or {"train": 80, "test": 40}, output_dir=out_dir)
    cfg["override"] = {"num_epochs": {"global": 4, "local": 1},
                       "conv": {"hidden_size": [4, 8]},
                       "batch_size": {"train": 10, "test": 20},
                       "sampler": "prp", "superstep_rounds": 2, "eval_interval": 2, **over}
    return C.process_control(cfg)


@contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN's deterministic algorithms for the body, the setting put back
    after."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _final_params(result) -> Dict[str, Any]:
    return {k: v.detach().cpu().numpy() for k, v in result["params"].items()}


def _params_equal(a: Dict[str, Any], b: Dict[str, Any]) -> bool:
    import numpy as np

    return set(a) == set(b) and all(
        a[k].shape == b[k].shape and np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def _run_once(cfg: Dict[str, Any], seed: int, injector=None):
    from ..entry.common import FedExperiment

    exp = FedExperiment(cfg, seed)
    exp.chaos = injector
    return exp, exp.run("Global-Accuracy")


def _free_dead_run(kill: BaseException) -> None:
    """What a real process death frees: the kill's traceback holds the dead
    run's frames (its engine's CUDA graphs, its cohort ring's pinned slots
    and copy events, a staged fetch); drop it and collect them now, so
    nothing of them is destroyed inside the resumed run's captures."""
    kill.__traceback__ = None
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reference_params(cfg_over: Dict[str, Any], out_root: str, seed: int = 0,
                     **cfg_kw) -> Dict[str, Any]:
    """The uninterrupted run's final params (host arrays), under cuDNN's
    deterministic algorithms: what a kill drill's resumed run must equal."""
    with deterministic_cudnn():
        _, ref = _run_once(drill_cfg(os.path.join(out_root, "ref"), **cfg_kw, **cfg_over), seed)
    return _final_params(ref)


def run_kill_drill(plan, cfg_over: Dict[str, Any], out_root: str, seed: int = 0,
                   max_resumes: int = 8, reference: Optional[Dict[str, Any]] = None,
                   **cfg_kw) -> Dict[str, Any]:
    """One kill-plan drill (ref drill.py:111-169): the uninterrupted run
    (:func:`reference_params`, or ``reference`` when the caller has it from
    a run of the same federation), then kill / corrupt / resume until the
    run completes; ``ok`` when the final params are equal bit for bit.
    ``plan``: a :class:`~heterofl_tpu_torch.chaos.FaultPlan` (its poison
    ignored here); ``cfg_kw`` goes to :func:`drill_cfg`."""
    from .. import config as C
    from ..utils.checkpoint import checkpoint_path, generation_path
    from . import ChaosKill, FaultInjector, corrupt_blob

    t0 = time.time()
    ref_params = reference if reference is not None else \
        reference_params(cfg_over, out_root, seed, **cfg_kw)
    with deterministic_cudnn():
        cfg_ch = drill_cfg(os.path.join(out_root, "chaos"), **cfg_kw, **cfg_over)
        injector = FaultInjector(plan)
        resumes, corruptions, applied_corrupt = 0, [], False
        while True:
            cfg_run = dict(cfg_ch, resume_mode=0 if resumes == 0 else 1)
            try:
                _, res = _run_once(cfg_run, seed, injector)
                break
            except ChaosKill as ck:
                _free_dead_run(ck)
                resumes += 1
                if resumes > max_resumes:
                    raise RuntimeError(f"kill drill did not converge after {max_resumes} "
                                       f"resumes (last kill: {ck})")
                if not applied_corrupt and plan.corrupt:
                    # between the kill and the resume: the resume must fall
                    # back loudly to an older generation
                    applied_corrupt = True
                    tag = C.make_model_tag(seed, cfg_ch)
                    for c in plan.corrupt:
                        p = generation_path(checkpoint_path(cfg_ch["output_dir"], tag,
                                                            c["which"]), c["generation"])
                        if os.path.exists(p):
                            corruptions.append(corrupt_blob(p, c["mode"]))
        chaos_params = _final_params(res)
    ok = _params_equal(ref_params, chaos_params)
    return {"drill": "kill", "ok": ok, "plan": {"kills": plan.kills, "corrupt": plan.corrupt},
            "kills_fired": injector.fired, "resumes": resumes, "corruptions": corruptions,
            "bitwise_equal": ok, "cudnn_deterministic": True,
            "wall_sec": round(time.time() - t0, 2)}


def pick_poison_uid(cfg: Dict[str, Any], seed: int, round_: int,
                    max_retries: int = 3) -> Optional[int]:
    """A uid of round ``round_``'s cohort that the same round under none of
    the first ``max_retries`` rollbacks draws, so a rollback dodges the
    poison on its first replay (and every later one).  The port's own
    streams: rollback n salts the round-seed stream's root
    (``entry.common.salt_seed(root, RETRY_SALT + n)``, the salts
    compounding), and under ``prp`` a round's cohort is the ``prp`` map of
    its round seed (``fed.core.round_users``), its availability row
    applied."""
    from ..entry.common import salt_seed
    from ..fed.core import round_seed, round_users
    from ..fed.sampling import resolve_sampler_cfg
    from ..obs.watchdog import RETRY_SALT
    from ..sched import resolve_schedule_cfg

    if resolve_sampler_cfg(cfg).kind != "prp":
        raise ValueError("pick_poison_uid predicts the 'prp' sampler's draws only: the "
                         "'perm' stream is stateful")
    sched = resolve_schedule_cfg(cfg)
    users = cfg["num_users"]
    active = int(math.ceil(cfg["frac"] * users))

    def row(root: int):
        drawn = round_users(round_seed(root, round_), users, active, "prp", None,
                            sched.avail_row(round_))
        return {int(u) for u in drawn if u >= 0}

    orig = row(seed)
    root, retry_rows = seed, []
    for n in range(1, max_retries + 1):
        root = salt_seed(root, RETRY_SALT + n)
        retry_rows.append(row(root))
    # a uid absent from every retry's draw; dodging the first alone suffices
    # (a clean first replay completes the run)
    for u in sorted(orig):
        if all(u not in rr for rr in retry_rows):
            return u
    for u in sorted(orig):
        if u not in retry_rows[0]:
            return u
    return None


def _read_log(cfg: Dict[str, Any], tag: str) -> List[Dict[str, Any]]:
    path = os.path.join(cfg["output_dir"], "runs", f"train_{tag}", "log.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def run_poison_drill(mode: str, cfg_over: Dict[str, Any], out_root: str, seed: int = 0,
                     poison_round: int = 3, max_retries: int = 3, **cfg_kw) -> Dict[str, Any]:
    """One poison drill (ref drill.py:222-292): a drawn (round, uid) update
    made NaN, and the run completes -- ``quarantine`` through the gate,
    ``rollback`` through the watchdog (telemetry on, no backoff).  The
    report: the poison, finite final params, the quarantined count or the
    trips and recoveries with the time from the trip to the first replayed
    round's record (``mttr_sec``, host clock)."""
    import numpy as np

    if mode not in ("quarantine", "rollback"):
        raise ValueError(f"Not valid poison drill mode: {mode!r} "
                         f"('quarantine' or 'rollback')")
    t0 = time.time()
    base_cfg = drill_cfg(os.path.join(out_root, mode), **cfg_kw, **cfg_over)
    uid = pick_poison_uid(base_cfg, seed, poison_round, max_retries=max_retries)
    if uid is None:
        raise RuntimeError(
            f"no dodgeable poison uid at round {poison_round}: every "
            f"cohort member recurs in all {max_retries} salted redraws "
            f"(grow num_users or lower frac)")
    over = dict(cfg_over, chaos_poison=[[poison_round, int(uid)]])
    if mode == "quarantine":
        over["quarantine"] = "on"
    else:
        over["telemetry"] = "on"
        over["watchdog"] = {"action": "rollback", "max_retries": max_retries, "backoff": 0.0}
    cfg = drill_cfg(os.path.join(out_root, mode), **cfg_kw, **over)
    with deterministic_cudnn():
        exp, res = _run_once(cfg, seed)
    params = _final_params(res)
    finite = all(bool(np.all(np.isfinite(v))) for v in params.values())
    log = _read_log(cfg, exp.tag)
    report: Dict[str, Any] = {"drill": f"poison-{mode}", "poison": [poison_round, int(uid)],
                              "final_params_finite": finite, "cudnn_deterministic": True,
                              "wall_sec": round(time.time() - t0, 2)}
    if mode == "quarantine":
        quarantined = sum(int(r.get("quarantined") or 0) for r in log
                          if r.get("tag") == "obs" and r.get("event") == "probes")
        report["quarantined_total"] = quarantined
        report["ok"] = finite and quarantined >= 1
    else:
        trips = [r for r in log if r.get("tag") == "obs" and r.get("event") == "watchdog"]
        recoveries = [r for r in log if r.get("tag") == "recovery"]
        report["trips"] = len(trips)
        report["recoveries"] = len(recoveries)
        report["escalated_to_abort"] = False  # run() raised otherwise
        replayed = [r["epoch"] for r in res["history"]]
        report["poison_dodged"] = int(uid) not in res["history"][poison_round - 1]["users"]
        mttr = None
        if trips and recoveries:
            after = [r["t"] for r in log if r.get("tag") == "train"
                     and r["t"] > recoveries[-1]["t"]]
            if after:
                mttr = round(min(after) - trips[0]["t"], 3)
        report["mttr_sec"] = mttr
        report["ok"] = (finite and len(recoveries) >= 1 and report["poison_dodged"]
                        and replayed == list(range(1, len(replayed) + 1)))
    return report


def _say(reports: List[Dict[str, Any]], ok: bool, json_out: bool, extra=None) -> None:
    if json_out:
        print(json.dumps({"ok": ok, **(extra or {}), "drills": reports}))
        return
    for r in reports:
        print(f"[{'ok' if r['ok'] else 'FAIL'}] {r['drill']}: "
              + json.dumps({k: v for k, v in r.items() if k not in ("drill", "ok")}))


def run_smoke(out_root: str, json_out: bool = False, **cfg_kw) -> int:
    """The smoke (ref drill.py:295-313): ONE kill plan (a death before the
    second checkpoint write, resumed bit for bit) and ONE poison plan
    (rollback recovery), at the drill's small widths."""
    from . import resolve_fault_plan

    plan = resolve_fault_plan({"kills": [{"point": "checkpoint", "at": 2}]})
    reports = [run_kill_drill(plan, {}, os.path.join(out_root, "kill"), **cfg_kw),
               run_poison_drill("rollback", {}, os.path.join(out_root, "poison"), **cfg_kw)]
    ok = all(r["ok"] for r in reports)
    _say(reports, ok, json_out, {"smoke": True})
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m heterofl_tpu_torch.chaos.drill",
        description="chaos drill: kill/corrupt/poison a federated run and "
                    "assert the recovery contract")
    parser.add_argument("--plan", default=None,
                        help="JSON fault plan: {kills: [{point, at}], "
                             "corrupt: [{which, mode, generation}], "
                             "poison: [[round, uid]]}")
    parser.add_argument("--poison-mode", default="rollback", choices=("quarantine", "rollback"),
                        help="recovery mechanism for poison drills")
    parser.add_argument("--strategy", default="masked", choices=("masked", "grouped"))
    parser.add_argument("--store", default="eager", choices=("eager", "stream"))
    parser.add_argument("--superstep", type=int, default=2)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--control", default=DRILL_CONTROL,
                        help="the control string (default: 8 users, levels a and b)")
    parser.add_argument("--data", default="MNIST", help="the synthetic dataset")
    parser.add_argument("--model", default="conv", help="the model (conv, resnet18, ...)")
    parser.add_argument("--sizes", default=None,
                        help='JSON synthetic sizes (default {"train": 80, "test": 40})')
    parser.add_argument("--override", default=None,
                        help="JSON cfg overrides, e.g. widths or batch sizes")
    parser.add_argument("--out", default=None, help="work dir (default: a tempdir)")
    parser.add_argument("--smoke", action="store_true",
                        help="one kill (before the 2nd checkpoint) + one rollback poison")
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    from .. import resolve_device

    resolve_device({"device": args.device})
    cfg_kw = {"device": args.device, "control": args.control, "data_name": args.data,
              "model_name": args.model, "sizes": json.loads(args.sizes) if args.sizes else None}
    out_root = args.out or os.path.join(os.environ.get("TMPDIR", "/tmp"),
                                        f"chaos_drill_{os.getpid()}")
    if args.smoke:
        return run_smoke(out_root, json_out=args.json, **cfg_kw)
    over = {"strategy": args.strategy, "client_store": args.store,
            "superstep_rounds": args.superstep,
            "num_epochs": {"global": args.rounds, "local": 1},
            **(json.loads(args.override) if args.override else {})}
    from . import resolve_fault_plan

    plan = resolve_fault_plan(json.loads(args.plan) if args.plan
                              else {"kills": [{"point": "superstep", "at": 2}]})
    reports = []
    if plan.kills or plan.corrupt:
        reports.append(run_kill_drill(plan, over, os.path.join(out_root, "kill"),
                                      seed=args.seed, **cfg_kw))
    if plan.poison is not None:
        # each poisoned round drills on its own, so a report names one contract
        for r, _u in [tuple(p) for p in plan.poison.tolist()]:
            reports.append(run_poison_drill(args.poison_mode, over,
                                            os.path.join(out_root, f"poison_r{r}"),
                                            seed=args.seed, poison_round=int(r), **cfg_kw))
    ok = all(r["ok"] for r in reports) and bool(reports)
    _say(reports, ok, args.json)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
