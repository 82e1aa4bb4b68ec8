"""The runtime audit of the round programs on one device (ref
staticcheck/audit.py).

The reference lowers its round programs and walks their jaxprs and HLO;
the port has no program to lower, so the audit builds each round program
the way the driver does (``entry.common.FedExperiment`` on synthetic data,
its engine and its staged stacks), dispatches it twice with fresh but
identical host inputs, and watches it run:

(a) **no float64** in the round's params, the step's static buffers, the
    staged stacks or the payload it reduces, and at most **one
    ``host_fetch`` a superstep** (``parallel/staging.host_fetch``, the
    superstep's one device-to-host copy);
(b) **launches a replayed step** against the committed budget
    (``baseline.json``'s section of the device): on the card the kernel
    nodes of the step's capture (:func:`.kernels.graph_kernels`), 15%
    headroom as the reference's ``step_body.fusions``; on the CPU the
    step's aten operators (:func:`.kernels.op_count`), exact.  The
    telemetry programs' probes and gate run after the aggregation, so
    their steps launch exactly what their plain twins' do;
(c) **no recapture**: the second dispatch leaves ``len(StepGraphs.steps)``
    (the port's program cache, filled on the CPU too) and
    ``step_graph.STATS["captures"]`` unchanged, and the graphs are at most
    the keys the schedule can draw (a width rate a step, masked; a (level,
    G) a step, grouped -- G is not bucketed);
(d) **FLOP shares** (:func:`flop_budget_check`): each level's step FLOPs
    against :func:`~..fed.core.level_flop_shares`, at the reference's
    tolerances and with strict monotonicity;
(e) **wire bytes by equality** (:mod:`.wire`) and the int8 frontier;
(f) **memory** under the analytic ceiling (:mod:`.memory`): on the card
    the program's peak allocated bytes and its graph pool's growth;
(g) **collectives** (ref audit.py:1243-1420, "exactly one psum a round"):
    both engines' rounds reduce over the clients mesh axis, so each
    dispatch makes exactly one ``Mesh.all_reduce_sum`` a round (the
    grouped engine's under a per-level map too: every level's payload in
    one buffer) and one ``Mesh.gather_rows`` (a K=1 round's rows, a
    superstep's k rounds'), read from ``parallel/mesh.py``'s counters (the
    payload each moves is check (e)'s); the record carries the payload's
    bytes and the ring all-reduce's bytes a rank at the mesh's size
    (:func:`.wire.ring_allreduce_bytes`); then one evaluation after the
    dispatches, host and (a superstep program) fused, makes one all-reduce
    an sBN and a Global pass and one gather a Local pass.  On a data axis
    (a mesh of ``data`` > 1, under torchrun) each dispatch's data-group
    collectives are its eager local steps (a grouped level step counts
    once for its G clients) times :func:`data_step_budget`, both engines.

Programs: the masked and grouped engines at K=1 and in the superstep
(K=2); dense, int8 and the grouped per-level codec map; ``telemetry``
``on`` and ``hist``; the ``perm`` and ``prp`` samplers; vision, and the
LM at K=1.  ``default_audit_cfg(flagship=False)`` keeps the conv net at
test widths for the CPU; ``flagship=True`` takes the headline's full
ResNet-18 widths (and the full transformer) for the card.
"""

from __future__ import annotations

import contextlib
import fnmatch
import gc
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import config as C
from ..analysis.summary import example_batch, flop_count, model_forward, module_table
from ..compress import LOSSY_CODECS
from ..fed.core import (_MATMUL_LIKE, level_byte_table, level_codec_byte_table,
                        level_codec_map_byte_table, level_flop_shares, level_flop_table,
                        round_seed, superstep_rate_schedule, superstep_user_schedule)
from ..models import make_model
from ..parallel import mesh as mesh_mod
from ..parallel import staging, step_graph
from .kernels import step_launches
from .memory import analytic_budget, check_memory
from .report import AuditReport, ProgramReport
from .wire import check_wire, codec_frontier, ring_allreduce_bytes

#: the FLOP-share tolerance (max relative error of a level's measured
#: share against the analytic one): 2% at the headline's widths, where the
#: products dominate; at test widths the width-independent costs weigh on
#: the small levels, so the bound is looser and strict monotonicity
#: carries the regression-catching weight (ref audit.py:95-96)
FLAGSHIP_FLOP_TOL = 0.02
SMALL_FLOP_TOL = 0.45

#: a replayed step's launches over the committed budget: exact on the CPU
#: (aten operator counts are repeatable), 15% on the card (cuDNN's and
#: cuBLAS's choices move its kernel count)
LAUNCH_HEADROOM = {"cpu": 0.0, "cuda": 0.15}

#: the audited federation: 5 levels a1-e1 over 10 users, 5 a round, so a
#: round's cohort holds one client of each level
AUDIT_CONTROL = "1_10_0.5_iid_fix_a1-b1-c1-d1-e1_bn_1_1"
#: one local step a client (10 images a user at batch 10)
AUDIT_SIZES = {"train": 100, "test": 20}
LM_AUDIT_SIZES = {"train": 20000, "test": 2000}
SMALL_LM = {"embedding_size": 32, "num_heads": 2, "hidden_size": 64, "num_layers": 2,
            "dropout": 0.2}
#: the grouped per-level codec map of the audit (levels a-e)
AUDIT_CODEC_MAP = {"1.0": "dense", "0.5": "int8", "0.25": "int8", "0.125": "dense",
                   "0.0625": "int8"}
EPOCH0, LR = 1, 0.05


@dataclass(frozen=True)
class Program:
    """One audited round program: its name, engine, K and cfg overrides."""

    name: str
    strategy: str = "masked"
    k: int = 1
    over: Dict[str, Any] = field(default_factory=dict)
    lm: bool = False
    #: the plain program whose steps this one's must equal launch for launch
    twin: Optional[str] = None


PROGRAMS: Tuple[Program, ...] = (
    Program("masked/k1"),
    Program("masked/k2", k=2),
    Program("masked/k2-int8", k=2, over={"wire_codec": "int8"}),
    Program("masked/k2-telemetry", k=2, over={"telemetry": "on"}, twin="masked/k2"),
    Program("masked/k2-hist", k=2, over={"telemetry": "hist"}, twin="masked/k2"),
    Program("masked/k2-prp", k=2, over={"sampler": "prp"}),
    Program("grouped/k1", strategy="grouped"),
    Program("grouped/k2", strategy="grouped", k=2),
    Program("grouped/k2-map", strategy="grouped", k=2, over={"wire_codec": AUDIT_CODEC_MAP}),
    Program("lm/masked/k1", lm=True),
)


def default_audit_cfg(flagship: bool = False, device: str = "cpu", lm: bool = False,
                      output_dir: str = "./output", **over) -> Dict[str, Any]:
    """The audit's processed cfg: :data:`AUDIT_CONTROL` on synthetic data,
    one local epoch, the BN and SGD kernels on; the conv net at widths
    ``[8, 16]`` (LM: :data:`SMALL_LM`), or with ``flagship`` the headline's
    CIFAR10 ResNet-18 (LM: the full transformer) at full width."""
    cfg = C.default_cfg()
    cfg["control"] = C.parse_control_name(AUDIT_CONTROL)
    override: Dict[str, Any] = {"num_epochs": {"global": 4, "local": 1}}
    if lm:
        cfg.update(data_name="WikiText2", model_name="transformer",
                   synthetic_sizes=dict(LM_AUDIT_SIZES))
        if not flagship:
            override["transformer"] = dict(SMALL_LM)
    else:
        cfg.update(data_name="CIFAR10" if flagship else "MNIST",
                   model_name="resnet18" if flagship else "conv",
                   synthetic_sizes=dict(AUDIT_SIZES))
        if not flagship:
            override["conv"] = {"hidden_size": [8, 16]}
    cfg.update(synthetic=True, device=device, pallas_norm=True, fused_update=True,
               output_dir=output_dir, override=override)
    cfg.update(over)
    return C.process_control(cfg)


def with_data_fields(cfg: Dict[str, Any], seed: int = 0) -> Dict[str, Any]:
    """``cfg`` with its dataset's fields (``classes_size``, an LM's
    vocabulary), as the driver sets them (``data.process_dataset``)."""
    from ..data import fetch_dataset, process_dataset

    ds = fetch_dataset(cfg["data_name"], cfg["data_dir"], synthetic=True, seed=seed,
                       synthetic_sizes=cfg.get("synthetic_sizes"))
    return process_dataset(cfg, ds)[0]


def _tensors(obj):
    """Every tensor in a (nested) dict, list or tuple."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _key_str(key) -> str:
    return "/".join(f"{k:g}" if isinstance(k, float) else str(k) for k in key)


class _Recorder:
    """Watches one engine: the steps it asks its ``StepGraphs`` for (with
    their reset and generators) and the payload each round reduces, by
    level.  Instance attributes only; the engine's class and modules are
    untouched."""

    def __init__(self, eng, top: float):
        self.steps: Dict[Any, Tuple[Callable, Callable, tuple]] = {}
        self.levels: Dict[str, List[int]] = {}
        #: the dtypes of the payloads' tensors (not the tensors: holding
        #: them would add every round's payload to the peak the audit reads)
        self.dtypes: Set[torch.dtype] = set()
        graphs_get = eng.graphs.get

        def get(key, fn, reset, generators=()):
            self.steps.setdefault(key, (fn, reset, tuple(generators)))
            return graphs_get(key, fn, reset, generators)

        eng.graphs.get = get
        if eng.codec is not None:
            self._wrap_encode(eng.codec, top)
        if getattr(eng, "codec_map", None) is not None:  # grouped: each level's payload
            reduce_levels = eng._reduce_levels

            def rec_reduce(payloads):
                for rate, payload in payloads:
                    self._add(rate, list(payload.values()))
                return reduce_levels(payloads)

            eng._reduce_levels = rec_reduce
        elif eng.codec is None:
            aggregate = eng._aggregate

            def rec_aggregate(P, summed, counts, round_seed, n_slots, *a, **kw):
                if n_slots:
                    self._add(top, [summed, counts])
                return aggregate(P, summed, counts, round_seed, n_slots, *a, **kw)

            eng._aggregate = rec_aggregate

    def _add(self, rate: float, tensors: List[torch.Tensor]) -> None:
        self.levels.setdefault(f"{float(rate):g}", []).append(
            int(sum(t.nbytes for t in tensors)))
        self.dtypes.update(t.dtype for t in tensors)

    def _wrap_encode(self, codec, rate: float) -> None:
        encode = codec.encode

        def rec_encode(*a, **kw):
            payload, resid = encode(*a, **kw)
            self._add(rate, list(payload.values()))
            return payload, resid

        codec.encode = rec_encode


@contextlib.contextmanager
def _count_host_fetch():
    """Count ``parallel/staging.host_fetch`` calls in the block."""
    calls = [0]
    real = staging.host_fetch

    def counted(tree):
        calls[0] += 1
        return real(tree)

    staging.host_fetch = counted
    try:
        yield calls
    finally:
        staging.host_fetch = real


def _dispatch(exp, spec: Program, P0: torch.Tensor):
    """One dispatch of the program from ``P0``'s values with fresh host
    inputs (a new generator, new arrays): ``(P, host_fetch calls or
    None, the [k, A] cohort and rates)``."""
    cfg, eng = exp.cfg, exp.engine
    seed = exp.seed
    users = superstep_user_schedule(seed, EPOCH0, spec.k, cfg["num_users"], exp.num_active,
                                    exp.sampler, np.random.default_rng(seed), exp.sched)
    rates = superstep_rate_schedule(seed, EPOCH0, spec.k, cfg, users)
    P = P0.clone()
    if spec.k == 1:
        P, ms = eng.train_round(P, float(LR), np.array(users[0]), exp.train_data,
                                round_seed(seed, EPOCH0), rates=np.array(rates[0]))
        staging.PendingMetrics({k: v for k, v in ms.items() if torch.is_tensor(v)}).fetch()
        return P, None, users, rates
    with _count_host_fetch() as calls:
        P, pending = eng.train_superstep(P, seed, EPOCH0, spec.k, exp.train_data,
                                         np.array(users), np.array(rates),
                                         np.full(spec.k, LR, np.float32))
        pending.fetch()
    return P, calls[0], users, rates


def _drawable_keys(spec: Program, exp, users, rates) -> int:
    """The step keys the schedule can draw: its width rates (masked), its
    (level, G) pairs (grouped)."""
    cfg = exp.cfg
    grate = cfg["global_model_rate"]
    if spec.strategy == "masked":
        return len({float(r) / grate for r in np.asarray(rates).reshape(-1)})
    pairs = set()
    for row in np.asarray(rates):
        vals, cnt = np.unique(row, return_counts=True)
        pairs.update(zip(vals.tolist(), cnt.tolist()))
    return len(pairs)


def _program_budget(spec: Program, exp, rates) -> Dict[str, Any]:
    table = level_byte_table(exp.cfg)
    top = max(table)
    staged = sum(t.nbytes for t in _tensors(getattr(exp, "train_data", None)))
    for name in ("sbn_batches", "local_eval", "global_eval"):
        staged += sum(t.nbytes for t in _tensors(getattr(exp, name, None)))
    clients = 1
    if spec.strategy == "grouped":  # a level's clients step together
        clients = max(int(np.unique(row, return_counts=True)[1].max()) for row in rates)
    return analytic_budget(table[top]["param_bytes"], table[top]["activation_bytes"],
                           clients, staged)


def _expected_wire(spec: Program, cfg: Dict[str, Any]) -> Dict[float, int]:
    codec = cfg.get("wire_codec", "dense")
    if isinstance(codec, dict):
        return level_codec_map_byte_table(cfg, {float(k): v for k, v in codec.items()})
    table = level_codec_byte_table(cfg, codec)
    top = max(table)
    return {top: table[top]}


def audit_program(spec: Program, device: torch.device, flagship: bool, out_dir: str,
                  budget: Optional[Dict[str, Any]] = None, seed: int = 0,
                  tamper: Optional[Callable[[str, Any], None]] = None) -> ProgramReport:
    """Build, dispatch twice and check one program (module docstring,
    checks a-c, e, f).  ``budget`` is the committed baseline's entry of the
    program (its launches); ``tamper(name, experiment)`` runs after the
    program is built and before it is watched (the tests' seeded faults)."""
    from ..entry.common import FedExperiment

    rep = ProgramReport(spec.name)
    cuda = device.type == "cuda"
    # the programs audited before this one sit in reference cycles (a
    # captured step keeps its engine): collect them now, so their graph
    # pools are not freed during this program's captures
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    cfg = default_audit_cfg(flagship, device.type, lm=spec.lm, output_dir=out_dir,
                            strategy=spec.strategy, superstep_rounds=spec.k, **spec.over)
    exp = FedExperiment(cfg, seed)
    exp.stage(*exp.make_splits())
    eng = exp.engine
    if tamper is not None:
        tamper(spec.name, exp)
    top = max(float(r) for r in exp.cfg["model_rate"])
    rec = _Recorder(eng, top)
    P0 = eng.flatten(exp.model.params())
    if cuda:
        torch.cuda.synchronize(device)
        base_alloc = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    pool0 = step_graph.STATS["pool_bytes"]
    seen, colls = [], []
    for _ in range(2):
        cap0 = step_graph.STATS["captures"]
        c0, b0 = dict(mesh_mod.COLLECTIVES), dict(mesh_mod.COLLECTIVE_BYTES)
        d0, s0 = dict(mesh_mod.DATA_COLLECTIVES), getattr(eng, "local_steps", 0)
        P, fetches, users, rates = _dispatch(exp, spec, P0)
        seen.append((len(eng.graphs.steps), step_graph.STATS["captures"] - cap0, fetches))
        colls.append({k: mesh_mod.COLLECTIVES[k] - c0[k] for k in c0}
                     | {f"{k}_bytes": mesh_mod.COLLECTIVE_BYTES[k] - b0[k] for k in b0}
                     | {f"data_{k}": mesh_mod.DATA_COLLECTIVES[k] - d0[k] for k in d0}
                     | {"local_steps": getattr(eng, "local_steps", 0) - s0})
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base_alloc
    # (a) float64 and the superstep's fetches
    watched = [("params", {t.dtype for t in _tensors(P)}), ("payload", rec.dtypes),
               ("step buffers", {t.dtype for t in _tensors(getattr(eng, "_st", None))}),
               ("staged stacks", {t.dtype for t in _tensors(exp.train_data)})]
    for what, dtypes in watched:
        if torch.float64 in dtypes:
            rep.fail("float64", f"a float64 tensor in the round's {what}")
    if spec.k > 1:
        rep.host_fetches = max(s[2] for s in seen)
        if rep.host_fetches > 1:
            rep.fail("host-fetch", f"{rep.host_fetches} host_fetch calls in one superstep "
                     f"(at most 1: the superstep's one device-to-host copy)")
    # (c) recompile hazard
    rep.graphs, rep.captures = seen[0][0], seen[0][1]
    rep.recompile = {"after_first": seen[0][0], "after_second": seen[1][0],
                     "captures_first": seen[0][1], "captures_second": seen[1][1]}
    if seen[1][0] > seen[0][0] or seen[1][1] > 0:
        rep.fail("recompile-hazard", f"the second, identical dispatch grew the steps "
                 f"{seen[0][0]} -> {seen[1][0]} and captured {seen[1][1]} graph(s): a step "
                 f"key leaks a fresh host input")
    drawable = _drawable_keys(spec, exp, users, rates) if spec.k > 1 else 0
    if rep.graphs > drawable:
        rep.fail("recompile-hazard", f"{rep.graphs} captured steps for the {drawable} keys "
                 f"the schedule can draw")
    # (b) launches a replayed step
    for key, (fn, reset, gens) in sorted(rec.steps.items(), key=lambda kv: _key_str(kv[0])):
        rep.launches[_key_str(key)] = step_launches(fn, reset, gens, device)
    want = (budget or {}).get("launches") or {}
    head = LAUNCH_HEADROOM[device.type]
    for key, n in rep.launches.items():
        if key in want and n > want[key] * (1.0 + head):
            rep.fail("launch-budget", f"step {key}: {n} launches a replayed step, the "
                     f"committed budget is {want[key]} (+{head:.0%})")
    # (e) wire bytes by equality
    rep.wire = {"levels": rec.levels}
    check_wire(rep, rep.wire, _expected_wire(spec, exp.cfg))
    # (g) collectives over the clients mesh axis
    check_collectives(rep, spec, exp, colls)
    # (f) memory
    mem_budget = _program_budget(spec, exp, rates)
    rep.memory = {"budget": mem_budget}
    if cuda:
        pool = step_graph.STATS["pool_bytes"] - pool0
        rep.memory.update(peak_bytes=int(peak), pool_bytes=int(pool),
                          peak_mb=round(peak / 2 ** 20, 3), pool_mb=round(pool / 2 ** 20, 3))
        check_memory(rep, rep.memory, mem_budget)
    check_eval_collectives(rep, exp, P, spec.k > 1, out_dir)  # (g) the evaluation's, last
    return rep


def check_collectives(rep: ProgramReport, spec: Program, exp, colls: List[Dict[str, int]]
                      ) -> None:
    """Check (g) of one program from its two dispatches' collective counts
    ``colls`` (``parallel/mesh.py``'s counters' differences)."""
    mesh = exp.mesh
    worst = max(colls, key=lambda c: (c["all_reduce"], c["gather"]))
    per_round = worst["all_reduce"] / spec.k
    payload = worst["all_reduce_bytes"] // max(1, worst["all_reduce"])
    rep.collectives = {"all_reduce_per_round": per_round, "gathers": worst["gather"],
                       "payload_bytes_per_round": payload, "participants": mesh.size,
                       "ring_allreduce_bytes_per_device": ring_allreduce_bytes(payload,
                                                                               mesh.size),
                       "on_mesh": True}
    if any(c["all_reduce"] != spec.k for c in colls):
        rep.fail("collective-budget", f"{[c['all_reduce'] for c in colls]} all-reduces in "
                 f"the two dispatches of {spec.k} round(s): exactly one a round (the round's "
                 f"update sums and counts, or the codec's payload, in one buffer)")
    if any(c["gather"] != 1 for c in colls):
        rep.fail("collective-budget", f"{[c['gather'] for c in colls]} gathers in the two "
                 f"dispatches: exactly one a dispatch (the slots' metric rows)")
    check_data_collectives(rep, exp.model, mesh.data_size, colls)


def data_step_budget(model, n_data: int) -> Dict[str, int]:
    """The data axis's collectives of one local step at ``n_data`` ranks
    (none at 1): a vision step one all-reduce (its gradient and sums) and
    two a BN site (the forward's moments, the backward's sums); an LM step
    one all-reduce and ring attention's shifts, ``n - 1`` forward and ``n``
    backward a layer.  A grouped level step is one such step for its G
    clients at once (the engine's ``local_steps`` counts level steps): the
    level model has the global model's sites and layers.  Their bytes:
    ``staticcheck/wire.py::data_step_bytes``."""
    if n_data <= 1:
        return {"all_reduce": 0, "ring_shift": 0}
    if model.meta["kind"] == "transformer":
        return {"all_reduce": 1, "ring_shift": model.num_layers * (2 * n_data - 1)}
    sites = sum(k.endswith(".g") for k in model.specs) if model.norm == "bn" else 0
    return {"all_reduce": 1 + 2 * sites, "ring_shift": 0}


def check_data_collectives(rep: ProgramReport, model, n_data: int,
                           colls: List[Dict[str, int]]) -> None:
    """Check (g) over the data axis: each dispatch's data-group collectives
    are its local steps times :func:`data_step_budget` (the shifts staged
    through host memory recorded beside them)."""
    per = data_step_budget(model, n_data)
    rep.collectives["data_axis"] = {
        "n_data": n_data, "per_step": per,
        "dispatches": [{k: c.get(f"data_{k}", 0) for k in ("all_reduce", "ring_shift",
                                                          "ring_shift_host")}
                       | {"local_steps": c.get("local_steps", 0)} for c in colls]}
    for c in colls:
        got = {k: c.get(f"data_{k}", 0) for k in per}
        want = {k: c.get("local_steps", 0) * v for k, v in per.items()}
        if got != want:
            rep.fail("collective-budget", f"data axis: {got} collectives over "
                     f"{c.get('local_steps', 0)} local steps, want {want} ({per} a step)")


def check_eval_collectives(rep: ProgramReport, exp, P: torch.Tensor, fused: bool,
                           out_dir: str) -> None:
    """Check (g) of the evaluation after a program's dispatches: the host
    evaluation (and, for a superstep program, the fused one) makes one
    all-reduce an sBN and a Global pass and one gather a Local pass (the
    LM: one all-reduce, its Global pass)."""
    from ..utils.logger import Logger

    lm = exp.kind == "transformer"
    want = {"all_reduce": 1 if lm else 2, "gather": 0 if lm else 1}
    runs = [("eval_host", lambda: exp.evaluate(P, EPOCH0, Logger(out_dir, quiet=True)))]
    if fused:
        runs.append(("eval_fused", lambda: exp._fused_eval().run(P, EPOCH0)))
    for what, run in runs:
        c0 = dict(mesh_mod.COLLECTIVES)
        run()
        got = {k: mesh_mod.COLLECTIVES[k] - c0[k] for k in want}
        rep.collectives[what] = got
        if got != want:
            rep.fail("collective-budget", f"{what}: {got} collectives, want {want} (one "
                     f"all-reduce an sBN and a Global pass, one gather a Local pass)")


def level_step_flops(cfg: Dict[str, Any], rate: float, device: torch.device) -> float:
    """One local step of the level's dense sub-model (forward and backward)
    at the training batch: ``FlopCounterMode``'s count of its products plus
    the analytic rest of :func:`~..fed.core.level_flop_table` (norms, relu,
    pools, the optimizer, data preparation), which the counter cannot see
    (the BN kernels run through ctypes)."""
    grate = cfg["global_model_rate"]
    model = make_model(cfg, rate).init_(torch.Generator().manual_seed(0)).to(device)
    batch = example_batch(cfg, model, cfg["batch_size"]["train"], device)
    gen = torch.Generator(device=device).manual_seed(0)
    counted = flop_count(lambda: model_forward(model, batch, gen)[1].backward())
    products = sum(6.0 * row[4] for row in module_table(cfg, rate / grate)
                   if any(t in row[0] for t in _MATMUL_LIKE))
    return float(counted) + level_flop_table(cfg, [rate])[rate] - products


def flop_budget_check(report: AuditReport, cfg: Dict[str, Any], device: torch.device,
                      flagship: bool) -> Dict[str, Any]:
    """Each level's measured share of the step FLOPs against
    :func:`~..fed.core.level_flop_shares` (uniform weights: one client a
    level), and strict monotonicity of the measured FLOPs in the rate."""
    tol = FLAGSHIP_FLOP_TOL if flagship else SMALL_FLOP_TOL
    rates = sorted({float(r) for r in cfg["model_rate"]}, reverse=True)
    measured = {r: level_step_flops(cfg, r, device) for r in rates}
    total = sum(measured.values())
    analytic = level_flop_shares(cfg)
    sec: Dict[str, Any] = {"ok": True, "tol": tol,
                           "measured_flops": {f"{r:g}": measured[r] for r in rates},
                           "measured_shares": {f"{r:g}": measured[r] / total for r in rates},
                           "analytic_shares": {f"{r:g}": analytic[r] for r in rates}}
    for r in rates:
        ms, an = measured[r] / total, analytic[r]
        if abs(ms - an) / an > tol:
            report.fail(sec, "flop-budget", f"level {r:g}: measured FLOP share {ms:.4f} vs "
                        f"analytic {an:.4f} (rel err {abs(ms - an) / an:.3f} > tol {tol})")
    for hi, lo in zip(rates, rates[1:]):
        if measured[hi] <= measured[lo]:
            report.fail(sec, "flop-monotonicity", f"level {hi:g} step FLOPs "
                        f"({measured[hi]:.3e}) not above level {lo:g} ({measured[lo]:.3e})")
    return sec


def codec_frontier_check(report: AuditReport, head_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Each lossy codec's payload a round at the headline's widths against
    dense, from the one bytes formula (ref audit.py:1202-1240); the int8
    payload past 25% of dense is a ``wire-frontier`` finding."""
    dense = level_codec_byte_table(head_cfg, "dense")
    top = max(dense)
    lossy = {name: level_codec_byte_table(head_cfg, name)[top] for name in LOSSY_CODECS}
    sec = codec_frontier(dense[top], lossy)
    if not sec["ok"]:
        report.fail(sec, "wire-frontier", f"the headline's int8 payload {lossy['int8']} B a "
                    f"round passes 25% of dense {dense[top]} B")
    return sec


def run_audit(device="cpu", flagship: bool = False, seed: int = 0,
              budget: Optional[Dict[str, Any]] = None, only: Optional[str] = None,
              tamper: Optional[Callable[[str, Any], None]] = None) -> AuditReport:
    """The whole audit on ``device`` -> :class:`~.report.AuditReport`.
    ``budget`` is the committed baseline's section of the device (the
    launch budgets); ``only`` an fnmatch glob over program names (the
    cross-program checks are skipped); ``tamper`` as in
    :func:`audit_program`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    report = AuditReport()
    cfg = with_data_fields(default_audit_cfg(flagship, device.type), seed)
    report.config = {"flagship": flagship, "data_name": cfg["data_name"],
                     "model_name": cfg["model_name"], "num_users": cfg["num_users"],
                     "levels": sorted({float(r) for r in cfg["model_rate"]}, reverse=True),
                     "device": device.type}
    progs = [p for p in PROGRAMS if only is None or fnmatch.fnmatch(p.name, only)]
    base = (budget or {}).get("programs") or {}
    with tempfile.TemporaryDirectory() as out_dir:
        for spec in progs:
            report.add_program(audit_program(spec, device, flagship, out_dir,
                                             base.get(spec.name), seed, tamper))
    for spec in progs:
        twin = report.programs.get(spec.twin) if spec.twin else None
        if twin is not None and report.programs[spec.name].launches != twin.launches:
            report.programs[spec.name].fail(
                "launch-budget", f"its steps launch {report.programs[spec.name].launches}, "
                f"its plain twin {spec.twin}'s {twin.launches}: the probes and the gate "
                f"must stay out of the step")
            report.ok = False
    if only is not None:
        report.config["only"] = only
        return report
    report.flop_budget = flop_budget_check(report, cfg, device, flagship)
    head = cfg if flagship else with_data_fields(default_audit_cfg(True, device.type), seed)
    report.wire_frontier = codec_frontier_check(report, head)
    return report

