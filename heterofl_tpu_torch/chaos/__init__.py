"""Chaos injection: failure as a replayable input.

Port of ``heterofl_tpu/chaos/__init__.py`` (its own copy, numpy only, the
reference's messages):

* :func:`resolve_poison_cfg` validates ``cfg['chaos_poison']``, a list of
  ``[round, uid]`` pairs whose client updates go NaN after local training
  and before aggregation (:mod:`.inject`, called by both engines) -- how
  the quarantine gate and the watchdog's rollback are proved;
* :class:`FaultPlan` (:func:`resolve_fault_plan`) names **kills** at the
  experiment loop's boundaries (:data:`KILL_POINTS`: a train dispatch, the metrics
  fetch, the checkpoint write, a streamed cohort's prefetch), byte
  **corruptions** of checkpoint generations on disk, and poisons;
* :class:`FaultInjector` counts each boundary inside the experiment loop
  (``FedExperiment._chaos``) and raises :class:`ChaosKill`, a
  ``BaseException`` no ``except Exception`` of the code under test can
  swallow, where the plan says die; its counters survive the kill and the
  resume, so one plan can kill a logical run several times;
* :func:`corrupt_blob` truncates a blob or flips one of its bytes.

``python -m heterofl_tpu_torch.chaos.drill`` (:mod:`.drill`) runs the experiment
loop under a plan and holds the recovery contract: every resume equals the
uninterrupted run bit for bit, a corrupted generation falls back loudly,
a poisoned run completes without intervention.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


#: the named boundaries of the experiment loop a FaultPlan may kill at -- each maps to one
#: ``FedExperiment._chaos(point)`` call site: ``superstep`` fires before a
#: train dispatch (superstep or K=1 round), ``fetch`` before the metrics
#: fetch/push, ``checkpoint`` before the blob write, ``prefetch`` before a
#: streaming cohort stages ahead.
KILL_POINTS = ("superstep", "fetch", "checkpoint", "prefetch")

#: checkpoint-corruption modes: ``truncate`` halves the blob, ``flip``
#: XORs one payload byte (the checksum must catch both).
CORRUPT_MODES = ("truncate", "flip")


class ChaosKill(BaseException):
    """A simulated process death at a named boundary of the experiment loop.

    Deliberately a ``BaseException`` (like ``KeyboardInterrupt``): a real
    ``kill -9`` is not catchable, so no ``except Exception`` recovery
    path in the code under test may see it either -- only the drill
    harness, which catches it explicitly and then resumes a FRESH
    experiment from disk."""

    def __init__(self, point: str, occurrence: int):
        super().__init__(f"chaos kill at {point!r} occurrence {occurrence}")
        self.point = point
        self.occurrence = occurrence


def resolve_poison_cfg(cfg: Dict[str, Any]) -> Optional[np.ndarray]:
    """Validate ``cfg['chaos_poison']`` and return the int32 ``[N, 2]``
    (round, uid) table, or None when unset (ref chaos/__init__.py:66-93,
    its messages)."""
    raw = cfg.get("chaos_poison")
    if raw is None:
        return None
    if not isinstance(raw, (list, tuple)) or not raw:
        raise ValueError(f"Not valid chaos_poison: {raw!r} (a non-empty "
                         f"list of [round, uid] pairs, or None)")
    table = []
    for item in raw:
        if (not isinstance(item, (list, tuple)) or len(item) != 2
                or any(not isinstance(v, int) or isinstance(v, bool)
                       or v < 0 for v in item)):
            raise ValueError(f"Not valid chaos_poison entry: {item!r} "
                             f"(a [round >= 0, uid >= 0] int pair)")
        table.append((int(item[0]), int(item[1])))
    if (cfg.get("strategy", "masked") or "masked") == "sliced":
        raise ValueError(
            "Not valid chaos_poison with strategy='sliced': the sliced "
            "debug twin has no in-program update to poison -- use a "
            "mesh-native strategy ('masked' or 'grouped')")
    return np.asarray(table, np.int32)


class FaultPlan:
    """One validated chaos plan: ``kills`` (point -> 1-based occurrence
    indices), ``corrupt`` (checkpoint byte corruptions the drill applies
    between the kill and the resume) and ``poison`` ((round, uid) pairs
    forwarded into ``cfg['chaos_poison']``)."""

    def __init__(self, kills: Sequence[Dict[str, Any]] = (),
                 corrupt: Sequence[Dict[str, Any]] = (),
                 poison: Optional[np.ndarray] = None):
        self.kills: Dict[str, List[int]] = {}
        for k in kills:
            self.kills.setdefault(k["point"], []).append(k["at"])
        self.corrupt = list(corrupt)
        self.poison = poison

    @property
    def n_kills(self) -> int:
        return sum(len(v) for v in self.kills.values())


def resolve_fault_plan(raw: Dict[str, Any]) -> FaultPlan:
    """Validate a plan dict (typically JSON from the drill CLI) into a
    :class:`FaultPlan` (ref chaos/__init__.py:117-159, its messages)."""
    if not isinstance(raw, dict):
        raise ValueError(f"Not valid fault plan: {raw!r} (a dict with "
                         f"optional kills/corrupt/poison lists)")
    unknown = set(raw) - {"kills", "corrupt", "poison"}
    if unknown:
        raise ValueError(f"Not valid fault plan keys: {sorted(unknown)} "
                         f"(kills/corrupt/poison)")
    kills = []
    for k in raw.get("kills") or []:
        if not isinstance(k, dict) or set(k) - {"point", "at"}:
            raise ValueError(f"Not valid kill spec: {k!r} "
                             f"({{'point': ..., 'at': n}})")
        point = k.get("point")
        if point not in KILL_POINTS:
            raise ValueError(f"Not valid kill point: {point!r} "
                             f"(one of {KILL_POINTS})")
        at = k.get("at", 1)
        if not isinstance(at, int) or isinstance(at, bool) or at < 1:
            raise ValueError(f"Not valid kill occurrence: {at!r} "
                             f"(a 1-based int)")
        kills.append({"point": point, "at": at})
    corrupt = []
    for c in raw.get("corrupt") or []:
        if not isinstance(c, dict) or set(c) - {"which", "mode", "generation"}:
            raise ValueError(f"Not valid corrupt spec: {c!r} ({{'which': "
                             f"'checkpoint'|'best', 'mode': 'truncate'|"
                             f"'flip', 'generation': g}})")
        which = c.get("which", "checkpoint")
        if which not in ("checkpoint", "best"):
            raise ValueError(f"Not valid corrupt target: {which!r} "
                             f"('checkpoint' or 'best')")
        mode = c.get("mode", "flip")
        if mode not in CORRUPT_MODES:
            raise ValueError(f"Not valid corrupt mode: {mode!r} "
                             f"(one of {CORRUPT_MODES})")
        gen = c.get("generation", 0)
        if not isinstance(gen, int) or isinstance(gen, bool) or gen < 0:
            raise ValueError(f"Not valid corrupt generation: {gen!r} "
                             f"(an int >= 0; 0 is the live blob)")
        corrupt.append({"which": which, "mode": mode, "generation": gen})
    poison = resolve_poison_cfg({"chaos_poison": raw.get("poison")})
    return FaultPlan(kills=kills, corrupt=corrupt, poison=poison)


class FaultInjector:
    """Counts the experiment loop's boundary occurrences and raises :class:`ChaosKill`
    when the plan schedules a death there.

    One injector SURVIVES across kill + resume cycles in the drill (the
    occurrence counters keep running), so a plan can schedule several
    kills along one logical run.  ``fired`` records every kill taken."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts: Dict[str, int] = {p: 0 for p in KILL_POINTS}
        self.fired: List[Tuple[str, int]] = []

    def check(self, point: str) -> None:
        if point not in self.counts:
            raise ValueError(f"unknown chaos point {point!r} "
                             f"(one of {KILL_POINTS})")
        self.counts[point] += 1
        n = self.counts[point]
        if n in self.plan.kills.get(point, ()):
            self.fired.append((point, n))
            raise ChaosKill(point, n)


def corrupt_blob(path: str, mode: str) -> Dict[str, Any]:
    """Corrupt one checkpoint blob on disk: ``truncate`` keeps the first
    half of the bytes, ``flip`` XORs one byte deep in the payload (past
    the header so the magic survives and the CHECKSUM must catch it).
    Returns a small record of what was done (the drill's report)."""
    with open(path, "rb") as f:
        raw = f.read()
    if mode == "truncate":
        out = raw[: max(1, len(raw) // 2)]
    elif mode == "flip":
        pos = min(len(raw) - 1, max(64, len(raw) // 2))
        out = raw[:pos] + bytes([raw[pos] ^ 0xFF]) + raw[pos + 1:]
    else:
        raise ValueError(f"Not valid corrupt mode: {mode!r} "
                         f"(one of {CORRUPT_MODES})")
    with open(path, "wb") as f:
        f.write(out)
    return {"path": path, "mode": mode, "bytes_before": len(raw),
            "bytes_after": len(out)}
