"""Client scheduler: who trains, for how long, and when the update lands.

Port of ``heterofl_tpu/sched/__init__.py`` (its own copy, numpy only, no
import of the reference): the registries (:data:`SCHEDULE_KINDS`,
:data:`AGGREGATION_KINDS`), the defaults, :func:`staleness_weight`,
:func:`markov_trace` (pure numpy, so bit for bit the reference's trace),
:class:`ScheduleSpec` and :func:`resolve_schedule_cfg` with every message
and cross-check of the reference.

* **who** -- an availability schedule: ``uniform`` (the plain cohort
  draw), ``trace`` (a recorded ``[T, U]`` 0/1 matrix, rounds cycling
  through its rows) or ``markov`` (a trace generated from a seeded
  per-client on/off chain).  Slots the availability cannot fill come back
  as ``-1`` (``fed.core.round_users``), which the engines treat as padding:
  they train nothing and report a zero metrics row.
* **for how long** -- a deadline: each active client gets a local-step
  budget in ``[ceil(min_frac * total), total]`` (:mod:`.deadline`), and
  its steps past the budget change nothing.
* **when it lands** -- buffered aggregation: a round's reduced ``(sums,
  counts)`` are applied one round late with the weight
  ``staleness_weight(alpha, 1)``, the buffer carried from round to round
  and checkpointed (:mod:`.buffer`).

Scenarios run on the ``masked`` and ``grouped`` engines; the ``sliced``
twin refuses them.  ``schedule=None`` is the lockstep default and leaves
every engine as it was.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np

#: the schedule registry (``cfg['schedule']['kind']``)
SCHEDULE_KINDS = ("uniform", "trace", "markov")

#: when a cohort's update lands (``cfg['schedule']['aggregation']``)
AGGREGATION_KINDS = ("sync", "buffered")

#: default staleness mixing coefficient of the buffered-async combine
DEFAULT_STALENESS = 0.5

#: default Markov on/off chain parameters (P(off->on), P(on->off), trace
#: length in rounds, trace seed)
DEFAULT_MARKOV = {"p_on": 0.5, "p_off": 0.2, "length": 64, "seed": 0}


def staleness_weight(alpha: float, staleness: int) -> float:
    """Mixing weight of a buffered update that is ``staleness`` rounds old:
    ``alpha / sqrt(1 + s)``, the polynomial staleness discount of
    FedBuff-style buffering.  The buffer holds exactly one round, so the
    engines evaluate it at ``s = 1``."""
    return float(alpha) / math.sqrt(1.0 + float(staleness))


def markov_trace(num_users: int, length: int, p_on: float, p_off: float,
                 seed: int) -> np.ndarray:
    """A replayable ``[length, num_users]`` uint8 availability trace from a
    seeded two-state Markov chain: each client flips off with ``p_off`` and
    back on with ``p_on`` per round, initialised at the stationary
    distribution.  Deterministic in ``seed`` -- re-running (or resuming)
    regenerates the identical trace, which is what makes Markov scheduling
    a special case of trace replay."""
    if num_users < 1 or length < 1:
        raise ValueError(f"markov trace needs num_users>=1, length>=1 "
                         f"(got {num_users}, {length})")
    rng = np.random.default_rng(int(seed))
    pi_on = p_on / max(p_on + p_off, 1e-12)
    state = rng.random(num_users) < pi_on
    rows = np.empty((length, num_users), np.uint8)
    for t in range(length):
        rows[t] = state
        u = rng.random(num_users)
        state = np.where(state, u >= p_off, u < p_on)
    return rows


class ScheduleSpec:
    """The resolved scheduler configuration, which the engines and the
    experiment loop read (built by :func:`resolve_schedule_cfg`).

    ``lockstep``: uniform sampling, no deadline and synchronous
    aggregation, every mechanism off -- the engines then run as they run
    without a schedule."""

    def __init__(self, kind: str = "uniform",
                 trace: Optional[np.ndarray] = None,
                 markov: Optional[Dict[str, Any]] = None,
                 deadline_min_frac: Optional[float] = None,
                 aggregation: str = "sync",
                 staleness: float = DEFAULT_STALENESS):
        self.kind = kind
        self._trace = trace
        self.markov = markov
        self.deadline_min_frac = deadline_min_frac
        self.aggregation = aggregation
        self.staleness = staleness

    @property
    def lockstep(self) -> bool:
        return (self.kind == "uniform" and self.deadline_min_frac is None
                and self.aggregation == "sync")

    @property
    def buffered(self) -> bool:
        return self.aggregation == "buffered"

    @property
    def has_deadline(self) -> bool:
        return self.deadline_min_frac is not None

    @property
    def trace(self) -> Optional[np.ndarray]:
        """The ``[T, U]`` uint8 availability matrix (``None`` for uniform).
        Markov kinds make their trace on first use and keep it."""
        if self.kind == "uniform":
            return None
        if self._trace is None and self.kind == "markov":
            m = self.markov
            self._trace = markov_trace(m["num_users"], m["length"],
                                       m["p_on"], m["p_off"], m["seed"])
        return self._trace

    def avail_row(self, epoch: int) -> Optional[np.ndarray]:
        """Round ``epoch``'s availability row (1-based epochs cycle through
        the trace), or ``None`` for uniform."""
        t = self.trace
        if t is None:
            return None
        return t[(int(epoch) - 1) % t.shape[0]]


def resolve_schedule_cfg(cfg: Dict[str, Any]) -> ScheduleSpec:
    """Validate ``cfg['schedule']`` and return the :class:`ScheduleSpec`.

    Unknown keys and malformed values raise ``ValueError`` with the
    reference's messages, at configuration time; so do the cross-checks
    against the strategy, the wire codec and ``superstep_rounds``.
    ``None``/absent -> the lockstep spec."""
    raw = cfg.get("schedule")
    if raw is None:
        return ScheduleSpec()
    if not isinstance(raw, dict):
        raise ValueError(f"Not valid schedule: {raw!r} (a dict with keys "
                         f"kind/trace/markov/deadline/aggregation/staleness, "
                         f"or None for lockstep)")
    unknown = set(raw) - {"kind", "trace", "markov", "deadline",
                          "aggregation", "staleness"}
    if unknown:
        raise ValueError(f"Not valid schedule keys: {sorted(unknown)}")
    kind = raw.get("kind", "uniform") or "uniform"
    if kind not in SCHEDULE_KINDS:
        raise ValueError(f"Not valid schedule kind: {kind!r} "
                         f"(one of {SCHEDULE_KINDS})")
    num_users = cfg.get("num_users")
    trace = None
    markov = None
    if kind == "trace":
        t = raw.get("trace")
        if t is None:
            raise ValueError("schedule kind 'trace' needs a 'trace' entry: "
                             "a [rounds, num_users] 0/1 availability matrix "
                             "(nested lists or an array)")
        trace = np.asarray(t)
        if trace.ndim != 2 or trace.size == 0:
            raise ValueError(f"Not valid availability trace shape "
                             f"{trace.shape}: needs [rounds, num_users] "
                             f"with both axes non-empty")
        vals = np.unique(trace)
        if not np.isin(vals, (0, 1)).all():
            raise ValueError(f"Not valid availability trace values "
                             f"{vals.tolist()[:8]}: 0/1 only")
        if num_users is not None and trace.shape[1] != int(num_users):
            raise ValueError(
                f"availability trace covers {trace.shape[1]} users but "
                f"cfg['num_users']={num_users}: the trace's user axis must "
                f"match the federation")
        trace = trace.astype(np.uint8)
    elif kind == "markov":
        m = dict(DEFAULT_MARKOV, **(raw.get("markov") or {}))
        unknown_m = set(m) - {"p_on", "p_off", "length", "seed"}
        if unknown_m:
            raise ValueError(f"Not valid schedule markov keys: "
                            f"{sorted(unknown_m)}")
        for p in ("p_on", "p_off"):
            v = m[p]
            if not isinstance(v, (int, float)) or not 0.0 < float(v) <= 1.0:
                raise ValueError(f"Not valid markov {p}: {v!r} "
                                 f"(a probability in (0, 1])")
        if not isinstance(m["length"], int) or m["length"] < 1:
            raise ValueError(f"Not valid markov length: {m['length']!r} "
                             f"(an int >= 1)")
        if num_users is None:
            raise ValueError("markov schedule needs cfg['num_users'] "
                             "(resolve after process_control)")
        markov = {"p_on": float(m["p_on"]), "p_off": float(m["p_off"]),
                  "length": int(m["length"]), "seed": int(m.get("seed", 0)),
                  "num_users": int(num_users)}
    elif raw.get("trace") is not None or raw.get("markov") is not None:
        raise ValueError(f"schedule kind {kind!r} takes no trace/markov "
                         f"entries (set kind='trace'/'markov')")
    deadline = raw.get("deadline")
    deadline_min_frac = None
    if deadline is not None:
        if not isinstance(deadline, dict) or set(deadline) - {"min_frac"}:
            raise ValueError(f"Not valid schedule deadline: {deadline!r} "
                             f"(a dict {{'min_frac': f}} with f in (0, 1), "
                             f"or None)")
        f = deadline.get("min_frac")
        if not isinstance(f, (int, float)) or not 0.0 < float(f) < 1.0:
            raise ValueError(f"Not valid deadline min_frac: {f!r} (the "
                             f"slowest client's fraction of the full local "
                             f"step budget, in (0, 1); 1.0 would be "
                             f"lockstep -- drop the deadline instead)")
        deadline_min_frac = float(f)
    agg = raw.get("aggregation", "sync") or "sync"
    if agg not in AGGREGATION_KINDS:
        raise ValueError(f"Not valid schedule aggregation: {agg!r} "
                         f"(one of {AGGREGATION_KINDS})")
    staleness = raw.get("staleness", DEFAULT_STALENESS)
    if not isinstance(staleness, (int, float)) \
            or not 0.0 < float(staleness) <= 1.0:
        raise ValueError(f"Not valid schedule staleness: {staleness!r} "
                         f"(the buffered combine's mixing coefficient, in "
                         f"(0, 1])")
    spec = ScheduleSpec(kind=kind, trace=trace, markov=markov,
                        deadline_min_frac=deadline_min_frac,
                        aggregation=agg, staleness=float(staleness))
    # the scheduler against the engine and the codec: a scenario the
    # engines cannot run is refused here, at configuration time
    strategy = cfg.get("strategy", "masked") or "masked"
    if not spec.lockstep and strategy == "sliced":
        raise ValueError(
            "Not valid schedule with strategy='sliced': scenarios "
            "(trace/markov availability, deadline, buffered aggregation) "
            "need a mesh-native strategy ('masked' or 'grouped'); the "
            "sliced debug twin replays the reference host loop")
    if spec.buffered:
        codec = cfg.get("wire_codec", "dense") or "dense"
        if isinstance(codec, dict) and all(v == "dense"
                                           for v in codec.values()):
            codec = "dense"  # an all-dense map collapses to the plain path
        if codec != "dense":
            raise ValueError(
                f"Not valid schedule aggregation='buffered' with "
                f"wire_codec={codec!r}: both add a scan carry with its "
                f"own donation/checkpoint contract -- pick one per "
                f"experiment")
        if strategy == "grouped" \
                and int(cfg.get("superstep_rounds", 1) or 1) <= 1 \
                and (cfg.get("client_store", "eager") or "eager") != "stream":
            raise ValueError(
                "Not valid schedule aggregation='buffered' with strategy="
                "'grouped' at superstep_rounds<=1 and client_store="
                "'eager': the K=1 host-orchestrated path combines in its "
                "own program and has no scan carry to buffer")
    return spec
